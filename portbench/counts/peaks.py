"""Published dense peaks by ``torch.cuda.get_device_name()`` (NVIDIA's data
sheet, SXM part, at its full 700 W power limit): float32 FLOP/s outside
the tensor cores, and device-memory bytes/s."""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"float32": 67e12, "hbm_bytes_per_s": 3.35e12},
}


def peak(name: str) -> dict:
    if name not in PEAKS:
        raise KeyError(f"no peak rates for {name!r}; known cards: {sorted(PEAKS)}")
    return PEAKS[name]


def least_seconds(nbytes: float, flops: float, name: str) -> float:
    """The least time the card could take: bytes at its memory rate against
    operations at its float32 rate, the larger."""
    p = peak(name)
    return max(nbytes / p["hbm_bytes_per_s"], flops / p["float32"])
