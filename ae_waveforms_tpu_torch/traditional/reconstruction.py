"""Gaussian-kernel beat reconstruction from fiducial points (the port of the
JAX package's ``traditional/reconstruction.py``; capability twin of
functions_traditional/signal_reconstruction.py:5-101).

Semantics, as in the JAX package:

- 13 anchor slots: baseline at x_t[0], the 11 fiducials (10 + R), baseline
  at x_t[-1]; NaN slots are dropped (sorted last, as +inf, by a stable
  sort), the survivors sorted by x, then duplicate x values nudged by +dt
  (13 passes of "+dt where an earlier slot holds the same value");
- per consecutive pair, a Gaussian bump anchored at the higher-y end with
  sigma = |dx| / sigma_map[i], where the divisor index i walks the
  *original* slot order and a pair that crosses dropped slots takes
  divisor 1;
- the bump is evaluated on the integer grid arange(int(x1), int(x2))
  (truncation toward zero) and affinely rescaled to hit both endpoints;
  pairs outside (x_t[0], x_t[-1]) or with dx <= 1 emit nothing; where the
  first and last values of a bump are equal, the division is left to give
  what it gives, as in the JAX package;
- the emitted segments are concatenated into a 1,024-sample buffer and the
  first M samples uniformly stretched onto x_t by linear interpolation; a
  buffer of M <= 1 gives buf[0].

Everything is float32 over fixed shapes on the caller's device, with no
Python loop over beats or candidates: what does not depend on the sigma
map (the sort, the nudge, the divisor walk, each buffer slot's segment and
offset, the stretch's indices) is computed once per batch of beats
(``_Anchors``), and the bumps for a chunk of candidates at a time, the
chunk sized from the bytes its (chunk, B, 1024) intermediates take, so a
result does not depend on the chunk.  The spline methods are numpy and
scipy on the host.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch

from ae_waveforms_tpu_torch import resolve_device

__all__ = [
    "reconstruct_gaussian",
    "reconstruct_gaussian_batch",
    "reconstruct_gaussian_sweep",
    "extract_coordinates",
    "reconstruct_akima",
    "reconstruct_pchip",
    "reconstruct_akima_pchip_mean",
]

N_SLOTS = 13  # baseline + 11 fiducials + baseline
N_PAIRS = N_SLOTS - 1
BUF = 1024  # >= the concatenated segments' length (x spans ~640 ms at 1 ms steps)
# bytes of (chunk, B, BUF) float32 intermediates a chunk of candidates may hold, and how many are live at once
CHUNK_BYTES = 1 << 30
LIVE_BUFFERS = 8


def _as_f32(device, *arrays):
    """The arrays as float32 tensors on ``device``, or, when it is None, on
    the device of the first tensor among them (the first CUDA device if
    none is a tensor: ``resolve_device``)."""
    if device is None:
        device = next((a.device for a in arrays if torch.is_tensor(a)), None)
    device = resolve_device(device)
    return [a.to(device, torch.float32) if torch.is_tensor(a)
            else torch.tensor(np.asarray(a), dtype=torch.float32, device=device) for a in arrays]


def _truncate(x: torch.Tensor) -> torch.Tensor:
    """int(x), toward zero; +inf (a dropped slot, whose pair emits nothing)
    as 0."""
    return torch.where(torch.isfinite(x), x, 0.0).to(torch.int32)


@dataclass
class _Anchors:
    """What the reconstruction of B beats needs that no sigma map changes."""

    dx: torch.Tensor  # (B, 12) |x2 - x1| of each pair after sorting and nudging
    div_idx: torch.Tensor  # (B, 12) the sigma map entry each pair divides by
    forced: torch.Tensor  # (B, 12) the pair crosses dropped slots: divisor 1
    a: torch.Tensor  # (B, 12) the bump's height, max(y1, y2)
    first_d2: torch.Tensor  # (B, 12) (int(x1) - mu)^2
    last_d2: torch.Tensor  # (B, 12) (int(x2) - 1 - mu)^2
    rising: torch.Tensor  # (B, 12) y2 > y1
    seg: torch.Tensor  # (B, BUF) the pair each buffer slot belongs to
    a_seg: torch.Tensor  # (B, BUF) a of that pair
    d2_seg: torch.Tensor  # (B, BUF) (t - mu)^2 at the slot's grid point t
    dy_seg: torch.Tensor  # (B, BUF) y2 - y1 (rising) or y1 - y2
    y0_seg: torch.Tensor  # (B, BUF) y1 (rising) or y2
    in_buf: torch.Tensor  # (B, BUF) slot < M
    lo: torch.Tensor  # (B, T) the stretch's lower and upper buffer slots and weight
    hi: torch.Tensor
    w: torch.Tensor
    stretched: torch.Tensor  # (B, 1) M > 1


def _anchors(xs: torch.Tensor, ys: torch.Tensor, x_t: torch.Tensor, baselines: torch.Tensor) -> _Anchors:
    B, dev = xs.shape[0], xs.device
    x_t0, x_t1 = x_t[0], x_t[-1]
    dt = x_t[1] - x_t[0]
    xs0 = torch.cat([x_t0.expand(B, 1), xs, x_t1.expand(B, 1)], 1)
    ys0 = torch.cat([baselines[:, None], ys, baselines[:, None]], 1)
    nan = torch.isnan(xs0) | torch.isnan(ys0)

    # drop NaN slots, sort the survivors by x (stable; +inf sinks)
    x_sortable = torch.where(nan, torch.inf, xs0)
    order = torch.argsort(x_sortable, dim=1, stable=True)
    x = x_sortable.gather(1, order)
    y = torch.where(nan, 0.0, ys0).gather(1, order)
    m = N_SLOTS - nan.sum(1, keepdim=True)

    slot = torch.arange(N_SLOTS, device=dev)
    earlier = slot[:, None] < slot[None, :]  # [k, l]: k before l
    for _ in range(N_SLOTS):  # duplicate nudging
        dup = ((x[:, None, :] == x[:, :, None]) & earlier).any(1) & torch.isfinite(x)
        x = torch.where(dup, x + dt, x)

    # the divisor walk over the original slot order: pair j divides by
    # sigma_map[i_j] unless slot i_j + 1 was dropped, then by 1; the next
    # pair's i is the first kept slot after i_j (i + 1 past slot 12)
    kept_at = torch.where(nan, N_SLOTS, slot)
    after = torch.cat([kept_at[:, 1:], torch.full((B, 1), N_SLOTS, device=dev)], 1)
    nxt = after.flip(1).cummin(1).values.flip(1)  # nxt[k]: first kept slot > k, else 13
    i = torch.zeros(B, dtype=torch.long, device=dev)
    idx, forced = [], []
    for _ in range(N_PAIRS):
        n_i = torch.where(i < N_SLOTS, nxt.gather(1, i.clamp(max=N_SLOTS - 1)[:, None])[:, 0], i + 1)
        idx.append(i.clamp(max=N_PAIRS - 1))
        forced.append(n_i > i + 1)
        i = n_i

    x1, x2, y1, y2 = x[:, :-1], x[:, 1:], y[:, :-1], y[:, 1:]
    pair_valid = torch.arange(1, N_SLOTS, device=dev) < m
    t1, t2 = _truncate(x1), _truncate(x2)
    emit = pair_valid & (x2 - x1 > 1) & (x2 > x_t0) & (x1 < x_t1)
    seg_len = torch.where(emit, (t2 - t1).clamp_min(0), 0).to(torch.int64)
    ends = seg_len.cumsum(1)  # offsets[1:]
    M = ends[:, -1:]

    a = torch.maximum(y1, y2)
    rising = y2 > y1
    mu = torch.where(rising, x2, x1)

    p = torch.arange(BUF, device=dev)
    seg = torch.searchsorted(ends, p.expand(B, BUF).contiguous(), right=True).clamp(max=N_PAIRS - 1)
    k = p - (ends - seg_len).gather(1, seg)
    tv = (t1.gather(1, seg) + k).to(torch.float32)

    Mf = M.clamp_min(2).to(torch.float32)
    f = ((x_t - x_t0) / (x_t1 - x_t0) * (Mf - 1.0)).clamp(min=0.0).minimum(Mf - 1.0)
    lo = f.floor().to(torch.int64)
    hi = torch.minimum(lo + 1, M - 1)
    return _Anchors(
        dx=(x2 - x1).abs(),
        div_idx=torch.stack(idx, 1),
        forced=torch.stack(forced, 1),
        a=a,
        first_d2=(t1.to(torch.float32) - mu) ** 2,
        last_d2=((t2 - 1).to(torch.float32) - mu) ** 2,
        rising=rising,
        seg=seg,
        a_seg=a.gather(1, seg),
        d2_seg=(tv - mu.gather(1, seg)) ** 2,
        dy_seg=torch.where(rising, y2 - y1, y1 - y2).gather(1, seg),
        y0_seg=torch.where(rising, y1, y2).gather(1, seg),
        in_buf=p < M,
        lo=lo.clamp(0, BUF - 1),
        hi=hi.clamp(0, BUF - 1),
        w=f - lo.to(torch.float32),
        stretched=M > 1,
    )


def _reconstruct(an: _Anchors, sigma_maps: torch.Tensor) -> torch.Tensor:
    """(S, 12) sigma maps -> (S, B, T) reconstructions of the anchored beats."""
    S, (B, T) = sigma_maps.shape[0], an.lo.shape
    div = torch.where(an.forced, 1.0, sigma_maps[:, an.div_idx])  # (S, B, 12)
    sigma = an.dx / div
    inv2s2 = 1.0 / (2.0 * sigma * sigma)
    g_first = an.a * torch.exp(-an.first_d2 * inv2s2)
    g_last = an.a * torch.exp(-an.last_d2 * inv2s2)
    g0 = torch.where(an.rising, g_first, g_last)
    den = torch.where(an.rising, g_last - g_first, g_first - g_last)
    seg = an.seg.expand(S, B, BUF)
    g = an.a_seg * torch.exp(-an.d2_seg * inv2s2.gather(2, seg))
    buf = (g - g0.gather(2, seg)) * an.dy_seg / den.gather(2, seg) + an.y0_seg
    buf = torch.where(an.in_buf, buf, 0.0)
    out = buf.gather(2, an.lo.expand(S, B, T)) * (1 - an.w) + buf.gather(2, an.hi.expand(S, B, T)) * an.w
    return torch.where(an.stretched, out, buf[:, :, :1])


def _chunks(an: _Anchors, sigma_maps: torch.Tensor) -> Iterator[torch.Tensor]:
    """The (chunk, B, T) reconstructions of successive chunks of the sigma
    maps, the chunk sized so its intermediates stay within CHUNK_BYTES."""
    B = an.seg.shape[0]
    chunk = max(1, CHUNK_BYTES // (B * BUF * 4 * LIVE_BUFFERS))
    for i in range(0, len(sigma_maps), chunk):
        yield _reconstruct(an, sigma_maps[i:i + chunk])


def reconstruct_gaussian_sweep(xs, ys, x_t, baselines, sigma_maps, device=None) -> torch.Tensor:
    """(S, 12) sigma candidates x (B, 11) fiducials -> (S, B, T), on
    ``device`` (by default the inputs' device, see ``_as_f32``)."""
    xs, ys, x_t, baselines, sigma_maps = _as_f32(device, xs, ys, x_t, baselines, sigma_maps)
    return torch.cat(list(_chunks(_anchors(xs, ys, x_t, baselines), sigma_maps)))


def reconstruct_gaussian_batch(xs, ys, x_t, baselines, sigma_map, device=None) -> torch.Tensor:
    """(B, 11) fiducials -> (B, T) reconstructions with one sigma map (12,)."""
    xs, ys, x_t, baselines, sigma_map = _as_f32(device, xs, ys, x_t, baselines, sigma_map)
    return _reconstruct(_anchors(xs, ys, x_t, baselines), sigma_map[None])[0]


def reconstruct_gaussian(x, y, x_t, baseline, sigma_map, device=None) -> torch.Tensor:
    """One-sample API mirroring the reference signature: x, y (11,), x_t
    (T,), baseline (), sigma_map (12,) -> (T,)."""
    x, y, x_t, baseline, sigma_map = _as_f32(device, x, y, x_t, baseline, sigma_map)
    return reconstruct_gaussian_batch(x[None], y[None], x_t, baseline.reshape(1), sigma_map)[0]


# ----- spline alternatives (host-side, like the reference's scipy use) -------


def extract_coordinates(x, y, x_t, baseline):
    """Host helper returning the cleaned anchors (numpy), for the spline
    methods and for tests."""
    xs = np.concatenate([[x_t[0]], np.asarray(x, float), [x_t[-1]]])
    ys = np.concatenate([[baseline], np.asarray(y, float), [baseline]])
    nan_mask = np.isnan(xs) | np.isnan(ys)
    xs, ys = xs[~nan_mask], ys[~nan_mask]
    order = np.argsort(xs, kind="stable")
    xs, ys = xs[order], ys[order]
    step = x_t[1] - x_t[0]
    for _ in range(len(xs)):
        dup = np.zeros(len(xs), bool)
        seen = {}
        for i, v in enumerate(xs):
            if v in seen:
                dup[i] = True
            else:
                seen[v] = i
        if not dup.any():
            break
        xs = xs + np.where(dup, step, 0.0)
    return xs, ys, nan_mask


def reconstruct_akima(x, y, x_t, baseline):
    from scipy.interpolate import Akima1DInterpolator

    xs, ys, _ = extract_coordinates(x, y, x_t, baseline)
    return Akima1DInterpolator(xs, ys)(x_t)


def reconstruct_pchip(x, y, x_t, baseline):
    from scipy.interpolate import PchipInterpolator

    xs, ys, _ = extract_coordinates(x, y, x_t, baseline)
    return PchipInterpolator(xs, ys)(x_t)


def reconstruct_akima_pchip_mean(akima, pchip):
    return (akima + pchip) / 2.0
