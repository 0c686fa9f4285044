"""P1 preamble detection: delay-multiply-average correlator (PyTorch).

The reference implements the EN 302 755 clause 10.1 correlator sample by
sample with running-sum buffers (reference/src/DVB_T2/p1_symbol.cpp:
57-181).  Here the two branch correlations are computed for *every*
candidate start position of a block at once via cumulative sums: a few
tensor ops over the whole search window, no per-sample state.  IQ is
complex64 on the receiver's device.

P1 structure (params/p1.py): [C | A | B] = 542 + 1024 + 482 samples, where
C = A[:542] * e^{j*2*pi*n/1024} and B = A[542:] * e^{j*2*pi*n/1024}.

For a candidate start t0 with y = x * e^{-j*2*pi*n/1024} (global f_SH
derotation):

  corr_C[t0] = sum_{i<542} y[t0+i]      * conj(x[t0+542+i])
  corr_B[t0] = sum_{j<482} y[t0+1566+j] * conj(x[t0+1084+j])

Both have phase -2*pi*t0/1024 (+/- the CFO term) and peak magnitude at the
true start; the product metric |corr_C * corr_B| gives the detection
statistic, and the fractional CFO falls out of
angle(corr_C * conj(corr_B)) = -(542 + 482) * cfo rad.

Precision: the windowed sums are differences of float32 cumulative sums,
as in the JAX package.  Over a 3.5 M-sample acquisition window each sum
carries a relative error of about 1e-4 to 1e-3, and the card's scan adds
in another order than the CPU's; the peak position is far coarser than
either.
"""
from __future__ import annotations

import numpy as np
import torch

from ..params import p1 as p1_mod

P1_LEN = p1_mod.P1_LEN            # 2048
_C, _A, _B = p1_mod.P1_C, p1_mod.P1_A, p1_mod.P1_B


def _windowed_sum(x: torch.Tensor, width: int, n_pos: int) -> torch.Tensor:
    cs = torch.cumsum(x, dim=0)
    cs = torch.cat([torch.zeros(1, dtype=x.dtype, device=x.device), cs])
    return cs[width:width + n_pos] - cs[:n_pos]


def _windowed_sum_c(x: torch.Tensor, width: int, n_pos: int) -> torch.Tensor:
    return torch.complex(_windowed_sum(x.real, width, n_pos),
                         _windowed_sum(x.imag, width, n_pos))


def correlate(x: torch.Tensor):
    """P1 correlation over all candidate starts in a block.

    x: [N] complex64 at elementary rate (64/7 Msps).  Returns
    (metric [N-2048], corr_c, corr_b) where metric[t0] is the normalized
    detection statistic for a P1 starting at t0.
    """
    n = x.shape[-1]
    n_pos = n - P1_LEN
    ph = (torch.remainder(torch.arange(n, dtype=torch.float32,
                                       device=x.device), 1024.0)
          * np.float32(2 * np.pi / 1024.0))
    y = x * torch.complex(torch.cos(ph), -torch.sin(ph))

    # corr_C: pairs (t0+i, t0+542+i), i < 542  -> lag 542, window 542
    pc = y[:n - _C] * x[_C:].conj()
    corr_c = _windowed_sum_c(pc, _C, n_pos)
    # corr_B: pairs (t0+1566+j, t0+1084+j), j < 482 -> window 482
    pb = y[_C + _A:] * x[_C + _A - _B:n - _B].conj()
    corr_b = _windowed_sum_c(pb, _B, n_pos)

    # normalize by in-window power so the metric is scale-free
    pw = x.real * x.real + x.imag * x.imag
    energy = _windowed_sum(pw, P1_LEN, n_pos)
    prod = corr_c * corr_b
    metric = (torch.sqrt(prod.real * prod.real + prod.imag * prod.imag)
              / torch.clamp(energy * energy * 0.063, min=1e-12))
    return metric, corr_c, corr_b


def detect(x: torch.Tensor):
    """Peak search: returns (t0, metric_peak, cfo_frac rad/sample) as
    0-d tensors on x's device.

    Picks the EARLIEST peak within 90% of the maximum (P1 preambles repeat
    every frame with near-equal metric; a bare argmax may land on a later
    frame and strand the stream with too few samples after lock), then the
    local maximum within that peak's neighborhood (the correlator ramps
    over ~P1_LEN samples, so a bare threshold would fire on the rising
    edge)."""
    metric, corr_c, corr_b = correlate(x)
    peak = torch.max(metric)
    # argmax of the first crossing: torch.argmax takes no booleans
    first = torch.argmax((metric >= 0.9 * peak).to(torch.uint8))
    near = torch.arange(metric.shape[0], device=x.device) < first + P1_LEN
    t0 = torch.argmax(torch.where(near, metric, -1.0))
    # CFO delta adds e^{-j*542*delta} to corr_C and e^{+j*482*delta} to
    # corr_B; the t0-dependent base phase cancels in the conjugate product,
    # leaving angle = -(542 + 482) * delta.
    rot = corr_c[t0] * corr_b[t0].conj()
    cfo = -torch.angle(rot) / (_C + _B)
    return t0, metric[t0], cfo


def decode_signalling(x_p1: np.ndarray, cfo_frac: float):
    """Host: decode S1/S2 from one detected 2048-sample P1 symbol.

    x_p1 is a host *complex* ndarray (this path runs on host NumPy).
    Returns (s1, s2, cfo_total rad/sample) or None; integer CFO search of
    +-10 carrier bins is inside decode_a_spectrum (params/p1.py, mirroring
    p1_symbol.cpp:117-126).
    """
    n = np.arange(P1_LEN)
    y = np.asarray(x_p1) * np.exp(-1j * cfo_frac * n)
    a = y[_C:_C + _A]
    spec = np.fft.fftshift(np.fft.fft(a))
    res = p1_mod.decode_a_spectrum(spec)
    if res is None:
        return None
    s1, s2, off = res
    return s1, s2, cfo_frac + 2 * np.pi * off / _A
