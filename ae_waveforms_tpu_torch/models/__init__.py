"""The autoencoders and the LSTM classifier as ``nn.Module``s, their layers
and the registry."""

from ae_waveforms_tpu_torch.models.registry import MODEL_REGISTRY, build_model

__all__ = ["MODEL_REGISTRY", "build_model"]
