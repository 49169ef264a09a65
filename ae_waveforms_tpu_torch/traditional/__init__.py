from ae_waveforms_tpu_torch.traditional.reconstruction import (
    reconstruct_gaussian,
    reconstruct_gaussian_batch,
    reconstruct_akima,
    reconstruct_pchip,
    reconstruct_akima_pchip_mean,
    extract_coordinates,
)

__all__ = [
    "reconstruct_gaussian",
    "reconstruct_gaussian_batch",
    "reconstruct_akima",
    "reconstruct_pchip",
    "reconstruct_akima_pchip_mean",
    "extract_coordinates",
]
