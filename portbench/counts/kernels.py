"""Bytes and operations each hand-written kernel's call needs (frozen copies
of ``chip_smoke.py``'s phases 2, 3 and 5), for its roofline share."""


def k1_hist(S: int, n: int, F: int, n_bins: int, half: int, matched: int):
    """K1, one level's left-child histograms of S fits on n rows: bins a
    byte each (two past 255 bins), g, h, node ids and shifts read once, the
    float32 histograms written once; a g and an h add per (row that adds,
    feature), ``matched`` rows adding (a left child of the level, g or h
    not zero).  Returns (bytes, operations)."""
    out_cells = S * 2 * half * F * n_bins
    in_bytes = (1 if n_bins <= 255 else 2) * F * n + 12 * S * n + 4 * S
    return in_bytes + 4 * out_cells, 2 * F * matched


def k2_route(S: int, n: int, F: int, width: int, levels: int, node_in: bool):
    """K2, ``levels`` levels of S fits' heaps from a level ``width`` nodes
    wide: the pool read, node ids out (and in, where given), 9 bytes a
    table node; a compare, a shift and an add a row and level."""
    nodes = width * (2**levels - 1)
    return 4 * F * n + 4 * S * n * (2 if node_in else 1) + 9 * S * nodes, 3 * S * n * levels


def k3_encoder(B: int, T: int = 320, h1: int = 128, h2: int = 64, latent: int = 10):
    """K3, the three encoder LSTMs over B beats: the input, the weights and
    the latents once; the products' multiply-adds."""
    flops = 2 * B * T * (4 * h1 * (1 + h1) + 4 * h2 * (h1 + h2) + 4 * latent * (h2 + latent))
    n_params = 4 * h1 * (1 + h1) + 8 * h1 + 4 * h2 * (h1 + h2) + 8 * h2 + 4 * latent * (h2 + latent) + 8 * latent
    return 4 * (B * T + n_params + B * latent), flops
