"""Gray-mapped QAM constellations (ETSI EN 302 755 clause 6.3.4).

Bit convention per cell (y0 .. y_{eta-1}): even-indexed bits modulate the I
axis, odd-indexed bits the Q axis; the first bit of each axis is the sign
(0 -> positive) and the remaining bits Gray-encode the magnitude with the
"iterated absolute fold" structure that also underlies the soft demapper
(|x| - 2^k thresholds; see the reference's hard decisions at
reference/src/DVB_T2/llr_demapper.cpp:296-352 for the same geometry).
"""
from __future__ import annotations

import functools
import numpy as np

from .modes import Constellation, NORM_FACTOR, BITS_PER_CELL, ROTATION


@functools.lru_cache(maxsize=None)
def axis_levels(bits_per_axis: int) -> np.ndarray:
    """Map axis bit-pattern index (sign bit first, MSB-first) -> level.

    Returns [2**bits_per_axis] float array of unnormalized odd levels.
    """
    n = bits_per_axis
    out = np.empty(1 << n, dtype=np.float64)
    for pattern in range(1 << n):
        bits = [(pattern >> (n - 1 - i)) & 1 for i in range(n)]
        sign = 1.0 if bits[0] == 0 else -1.0
        # decode magnitude from fold bits
        mags = np.arange(1, (1 << n), 2)
        for m in mags:
            r, ok = m, True
            t = 1 << (n - 1)
            for b in bits[1:]:
                want = 0 if r > t else 1
                if b != want:
                    ok = False
                    break
                r = abs(r - t)
                t >>= 1
            if ok:
                out[pattern] = sign * m
                break
    return out


@functools.lru_cache(maxsize=None)
def _map_tables(constellation: Constellation):
    eta = BITS_PER_CELL[constellation]
    per_axis = eta // 2
    levels = axis_levels(per_axis)
    return eta, per_axis, levels


def map_bits(bits: np.ndarray, constellation: Constellation,
             rotated: bool = False) -> np.ndarray:
    """[..., n*eta] bits -> [..., n] complex cells (normalized, opt. rotated)."""
    eta, per_axis, levels = _map_tables(constellation)
    b = np.asarray(bits, dtype=np.int64)
    shaped = b.reshape(*b.shape[:-1], -1, eta)
    i_bits = shaped[..., 0::2]
    q_bits = shaped[..., 1::2]
    weights = 1 << np.arange(per_axis - 1, -1, -1)
    i_idx = (i_bits * weights).sum(-1)
    q_idx = (q_bits * weights).sum(-1)
    cells = (levels[i_idx] + 1j * levels[q_idx]) * NORM_FACTOR[constellation]
    if rotated:
        cells = cells * np.exp(1j * ROTATION[constellation])
    return cells.astype(np.complex64)


def hard_bits(cells: np.ndarray, constellation: Constellation) -> np.ndarray:
    """[..., n] complex -> [..., n*eta] hard bits (no derotation applied)."""
    eta, per_axis, _ = _map_tables(constellation)
    c = np.asarray(cells) / NORM_FACTOR[constellation]
    out_bits = []
    for axis_vals in (c.real, c.imag):
        v = axis_vals
        axis_bits = [(v < 0).astype(np.uint8)]
        r = np.abs(v)
        t = 1 << (per_axis - 1)
        for _ in range(per_axis - 1):
            axis_bits.append((r <= t).astype(np.uint8))
            r = np.abs(r - t)
            t >>= 1
        out_bits.append(np.stack(axis_bits, axis=-1))
    i_b, q_b = out_bits
    inter = np.empty(c.shape + (eta,), dtype=np.uint8)
    inter[..., 0::2] = i_b
    inter[..., 1::2] = q_b
    return inter.reshape(*c.shape[:-1], -1)
