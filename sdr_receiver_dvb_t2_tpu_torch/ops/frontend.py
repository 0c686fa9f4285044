"""Streaming front-end DSP (PyTorch): IQ conditioning, NCO, resampler, FIR.

The reference front end is sample-serial with per-sample IIR feedback
(reference/src/DVB_T2/dvbt2_demodulator.h:59-155 ``convert_iq``,
dvbt2_demodulator.cpp:151-192 NCO + Farrow + FIR chain).  Here every stage
is a *block* operator with explicit carried state, so a whole ingest block
(hundreds of thousands of samples) runs as a handful of tensor ops on the
device:

  raw ints -> complex64 -> DC / IQ-imbalance correction (estimates from
  block N-1 applied to block N) -> NCO derotation (closed-form phase ramp,
  no recurrence) -> x4 half-band upsampling -> cubic Farrow fractional
  resampler (closed-form output positions -> a single gather, no
  phase-accumulator loop) -> anti-alias FIR decimator (a strided
  convolution).

IQ is complex64 on the device.  Every output has a static size: the
resampler produces a fixed ``n_out`` per block and the host carries the
fractional phase between blocks.  The convolutions are held to float32:
cuDNN would otherwise round their inputs to TF32 on the card
(``_conv_f32``).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# raw sample conversion (reference: convert_iq<T>, dvbt2_demodulator.h:68-115)
# ---------------------------------------------------------------------------

def raw_to_iq(block: torch.Tensor, fmt: str) -> torch.Tensor:
    """Interleaved raw IQ -> complex64, roughly unit scale.

    fmt: 'u8' (offset-binary bytes), 's8', 's16', 'f32'.
    """
    x = block.to(torch.float32)
    if fmt == "u8":
        x = x - 127.5
        scale = 1.0 / 128.0
    elif fmt == "s8":
        scale = 1.0 / 128.0
    elif fmt == "s16":
        scale = 1.0 / 32768.0
    elif fmt == "f32":
        scale = 1.0
    else:
        raise ValueError(f"unknown IQ format {fmt!r}")
    x = x.reshape(-1, 2) * scale
    return torch.complex(x[:, 0].contiguous(), x[:, 1].contiguous())


@dataclasses.dataclass
class IqCondState:
    """Carried conditioning state (all python floats; updated per block)."""
    dc_re: float = 0.0
    dc_im: float = 0.0
    c1: float = 0.0          # quadrature leakage I->Q
    c2: float = 1.0          # Q amplitude correction
    level: float = 0.0       # mean |I| + |Q| (AGC observable)


def iq_condition(x: torch.Tensor, c1, c2):
    """Apply DC + IQ-imbalance correction; measure fresh estimates.

    DC is removed *two-pass within the block* (the block's own mean: over
    ~1e6 samples its estimation noise is ~sigma/1000, while even 1%
    residual DC would rival the center carrier's amplitude since the spur
    concentrates into one FFT bin).  The IQ-imbalance correction applies
    the previous-block estimates (block-recurrent replacement for the
    reference's per-sample exponential loops, dvbt2_demodulator.h:89-153).
    Returns (y, stats): this block's raw measurements for the host to
    smooth into the next state, as one float32 tensor
    [dc_re, dc_im, theta1, theta2, theta3, level].
    """
    c1, c2 = _f32(c1, x.device), _f32(c2, x.device)
    dc_mean_re = torch.mean(x.real)
    dc_mean_im = torch.mean(x.imag)
    i = x.real - dc_mean_re
    q = x.imag - dc_mean_im
    q = (q - c1 * i) / c2
    # Moseley & Slump blind IQ-imbalance estimators (the reference uses the
    # 1-bit-quantized variant, dvbt2_demodulator.h:89-98)
    sgn_i = torch.sign(i)
    theta1 = torch.mean(sgn_i * q)
    theta2 = torch.mean(sgn_i * i)
    theta3 = torch.mean(torch.sign(q) * q)
    level = torch.mean(torch.abs(i) + torch.abs(q))
    stats = torch.stack([dc_mean_re, dc_mean_im, theta1, theta2, theta3,
                         level])
    return torch.complex(i, q), stats


def fold_iq_stats(state: IqCondState, stats, alpha: float = 0.05
                  ) -> IqCondState:
    """Host-side exponential smoothing of per-block measurements.

    The theta estimators are measured on the *corrected* output, so they are
    residuals; the new absolute correction composes them with the currently
    applied one: Q'' = ((Q - c1 I)/c2 - r1 I)/r2 = (Q - (c1 + c2 r1) I)/(c2 r2).
    """
    dc_re, dc_im, t1, t2, t3, level = (float(s) for s in stats)
    t2 = max(t2, 1e-12)
    r1 = t1 / t2
    r2 = float(np.sqrt(max(t3 * t3 - t1 * t1, 1e-24))) / t2
    c1_comp = state.c1 + state.c2 * r1
    c2_comp = state.c2 * r2
    mix = lambda old, new: old + alpha * (new - old)
    return IqCondState(
        dc_re=mix(state.dc_re, dc_re),
        dc_im=mix(state.dc_im, dc_im),
        c1=mix(state.c1, c1_comp),
        c2=mix(state.c2, c2_comp),
        level=mix(state.level, level),
    )


def _f32(v, device) -> torch.Tensor:
    """A scalar (python, numpy or tensor) as a float32 tensor on device."""
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def _cexp(ph: torch.Tensor) -> torch.Tensor:
    return torch.complex(torch.cos(ph), torch.sin(ph))


# ---------------------------------------------------------------------------
# NCO derotation (reference: dvbt2_demodulator.cpp:165-174)
# ---------------------------------------------------------------------------

def _rows(v, x: torch.Tensor) -> torch.Tensor:
    """A per-row scalar (python, numpy or tensor; one value or one per row
    of ``x``) as float32 on x's device, shaped to broadcast over x's last
    axis."""
    v = _f32(v, x.device)
    return v[..., None] if v.dim() else v


def nco_derotate(x: torch.Tensor, phase0, freq):
    """y[..., n] = x[..., n] * exp(-j(phase0 + freq*n)); returns
    (y, phase_end).

    ``x`` is one stream [N] or rows [R, N]; ``phase0`` and ``freq`` are
    scalars or one per row.  ``freq`` is radians/sample, float32 like the
    ramp.  The phase ramp is closed-form (no recurrence), so the whole
    block vectorizes; phase_end is carried to the next block by the host.
    """
    phase0, freq = _rows(phase0, x), _rows(freq, x)
    n = torch.arange(x.shape[-1], dtype=torch.float32, device=x.device)
    ph = phase0 + freq * n
    y = x * _cexp(-ph)
    phase_end = torch.remainder(phase0 + freq * x.shape[-1],
                                np.float32(2 * np.pi))
    return y, phase_end.squeeze(-1) if phase_end.dim() else phase_end


def spur_notch(x: torch.Tensor, phase0, omega, a_re, a_im):
    """Subtract a tracked CW spur a*exp(j(phase0 + omega*n)); returns
    (y, m) with m = [m_re, m_im], the block's measured complex spur
    amplitude at omega (correlation of the INPUT against the ramp).

    Block-recurrent replacement for the reference's per-sample anti-spur
    loop (dvbt2_demodulator.h:120-127): the host smooths m into the next
    block's amplitude and refines omega from m's block-to-block rotation
    (runtime/stream.py).  Phase continuity across blocks is host float64.

    Numerics: omega can sit anywhere in (-pi, pi], so a plain f32
    omega*arange ramp would lose ~0.16 rad over a 5e5-sample block.  The
    ramp is built per 1024-sample chunk from a mod-reduced chunk base
    (error < 1e-3 rad end to end, notch depth ~60 dB).
    """
    dev = x.device
    phase0, omega = _f32(phase0, dev), _f32(omega, dev)
    a_re, a_im = _f32(a_re, dev), _f32(a_im, dev)
    n_tot = x.shape[-1]
    ch = 1024
    n = torch.arange(n_tot, dtype=torch.int32, device=dev)
    c = torch.div(n, ch, rounding_mode="floor").to(torch.float32)
    r = torch.remainder(n, ch).to(torch.float32)
    two_pi = np.float32(2 * np.pi)
    step_c = torch.remainder(omega * ch, two_pi)
    ph = phase0 + torch.remainder(step_c * c, two_pi) + omega * r
    co, si = torch.cos(ph), torch.sin(ph)
    m_re = torch.mean(x.real * co + x.imag * si)
    m_im = torch.mean(x.imag * co - x.real * si)
    y = torch.complex(x.real - (a_re * co - a_im * si),
                      x.imag - (a_re * si + a_im * co))
    return y, torch.stack([m_re, m_im])


def detect_spur(iq: np.ndarray, min_ratio: float = 8.0):
    """Host-side CW spur search: (omega rad/sample, amp complex) or None.

    A spur stands out of the noise-like OFDM spectrum as a single FFT bin
    at >> the median magnitude (the reference arms its anti-spur by hand;
    here detection is automatic at acquisition time).  The FFT bin only
    localizes omega to ~1e-4 rad/sample, far too coarse for a notch whose
    phase must stay coherent over 1e5+-sample blocks, so the estimate is
    ladder-refined by phase differences over geometrically growing spans
    (each stage's unambiguous range covers the previous stage's residual),
    reaching ~1e-7 rad/sample.
    """
    x = np.asarray(iq)
    x = x - np.mean(x)
    n = 1 << 16
    if len(x) < n:
        n = 1 << int(np.floor(np.log2(max(len(x), 2))))
    spec = np.fft.fft(x[:n])
    mag = np.abs(spec)
    k = int(np.argmax(mag))
    med = float(np.median(mag))
    if mag[k] < min_ratio * med:
        return None
    omega = 2 * np.pi * (k if k < n // 2 else k - n) / n

    ns = 2048
    while 2 * ns <= len(x):
        seg = np.arange(ns)
        ramp = np.exp(-1j * omega * seg)
        m_a = np.mean(x[:ns] * ramp)
        m_b = np.mean(x[ns:2 * ns] * ramp * np.exp(-1j * omega * ns))
        if abs(m_a) > 0 and abs(m_b) > 0:
            omega += float(np.angle(m_b * np.conj(m_a))) / ns
        ns *= 4
    m = np.mean(x[:ns // 4 * 2] *
                np.exp(-1j * omega * np.arange(ns // 4 * 2)))
    return float(omega), complex(m)


# ---------------------------------------------------------------------------
# cubic Farrow fractional resampler
# (reference: DSP/interpolator_farrow.hh:41-68, sample-serial accumulator)
# ---------------------------------------------------------------------------

def split_step(step: float) -> tuple[np.float32, np.float32]:
    """Split a host double into hi + lo float32 parts (Dekker split).

    The resampler reconstructs exact sample positions from this two-float
    representation, so its position arithmetic stays float32.
    """
    hi = np.float32(step)
    lo = np.float32(step - float(hi))
    return hi, lo


_FARROW_CHUNK = 1024


def farrow_positions(mu0, step_hi, step_lo, n_out: int, device=None):
    """Farrow input positions p_i = mu0 + step*i as (idx int64 [..., n_out],
    d float32 [..., n_out]), with p = idx + d.  ``mu0``, ``step_hi`` and
    ``step_lo`` are scalars, or [R] for R rows of positions.

    Positions are computed per 1024-output chunk from an exact integer
    base plus a small float32 offset, keeping the fractional-delay error
    < 1e-4 samples over arbitrarily long blocks (float32 alone loses the
    fraction entirely beyond ~1e5 samples).
    """
    chunk = _FARROW_CHUNK
    if n_out % chunk:
        raise ValueError(f"n_out must be a multiple of {chunk}")
    n_chunks = n_out // chunk
    mu0 = _f32(mu0, device)[..., None]
    step_hi = _f32(step_hi, device)[..., None]
    step_lo = _f32(step_lo, device)[..., None]

    # exact per-chunk advance: chunk * step_hi is exact in f32 (chunk = 2^10)
    a_hi = chunk * step_hi
    i_adv = torch.floor(a_hi)
    f_adv = (a_hi - i_adv) + chunk * step_lo          # small, ~exact
    c = torch.arange(n_chunks, dtype=torch.float32, device=device)
    g = mu0 + c * f_adv                                # < n_chunks * 2
    idx_base = (c * i_adv + torch.floor(g)).to(torch.int32)   # exact int
    frac_base = g - torch.floor(g)

    i = torch.arange(chunk, dtype=torch.float32, device=device)
    # [..., n_chunks, chunk], each < ~1200
    p = frac_base[..., None] + i * step_hi[..., None]
    pf = torch.floor(p)
    idx = (idx_base[..., None] + pf.to(torch.int32)).flatten(-2)
    d = (p - pf).flatten(-2)
    return idx.to(torch.int64), d


def farrow_resample(x: torch.Tensor, mu0, step_hi, step_lo,
                    n_out: int) -> torch.Tensor:
    """Cubic (4-tap Lagrange) fractional resampler with static output size.

    Output i interpolates input position p_i = mu0 + step*i with
    step = step_hi + step_lo (see :func:`split_step`).  ``x`` is one stream
    [N] or rows [R, N] with per-row ``mu0``, ``step_hi``, ``step_lo``
    (each [R]).  The caller guarantees ceil(mu0 + step*(n_out-1)) + 2 <
    N and carries the fractional phase between blocks.  One gather over
    all rows + polynomial, no recurrence anywhere.
    """
    idx, d = farrow_positions(mu0, step_hi, step_lo, n_out, x.device)
    last = x.shape[-1] - 1

    def tap(o):
        return torch.gather(x, -1, torch.clamp(idx + o, 0, last))

    dm1, dp1, dm2 = d - 1.0, d + 1.0, d - 2.0
    cm1 = -d * dm1 * dm2 / 6.0
    c0 = dp1 * dm1 * dm2 / 2.0
    c1 = -dp1 * d * dm2 / 2.0
    c2 = dp1 * d * dm1 / 6.0
    return tap(-1) * cm1 + tap(0) * c0 + tap(1) * c1 + tap(2) * c2


# ---------------------------------------------------------------------------
# half-band 2x upsampler (pre-interpolation rate doubling)
#
# The cubic Farrow interpolator's alias images sit ~18 dB down when the
# signal occupies 0.38 of the input Nyquist (8 MHz DVB-T2 in a 10 Msps
# capture); each half-band doubling pushes the signal an octave down and
# buys ~12 dB.  Two stages (x4) put the implementation floor near 45 dB.
# The reference has no equivalent stage (its Farrow runs at the device
# rate and eats the distortion, dvbt2_demodulator.cpp:179-183).
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def halfband_taps(n_taps: int = 29, beta: float = 7.0) -> tuple:
    """Odd-length half-band lowpass (center tap at an even index)."""
    assert n_taps % 4 == 1, "need N = 4k+1 so even taps are zero"
    n = np.arange(n_taps) - (n_taps - 1) / 2.0
    h = np.sinc(n / 2.0) * np.kaiser(n_taps, beta)
    h[np.abs(n) % 2 == 0] = 0.0        # force exact half-band zeros
    h[(n_taps - 1) // 2] = 1.0
    h[1::2] *= 1.0 / (h.sum() - 1.0)   # DC gain exactly 2 (x2 interp)
    return tuple(h.astype(np.float32))


def _conv_f32(xp: torch.Tensor, taps: torch.Tensor, stride: int):
    """FIR of complex streams as one grouped conv1d over their real and
    imaginary parts: a stream [L] is two channels (``groups=2``), rows
    [R, L] are 2R channels (``groups=2R``), all in float32.

    ``conv1d`` correlates, so the taps go in reversed (a true convolution,
    as the JAX front end passes ``taps[::-1]`` to ``conv_general_dilated``).
    On the card cuDNN would round the inputs to TF32 (~1e-3 relative) by
    default; the flags below hold this call to float32 and restore the
    caller's setting afterwards.
    """
    lead = xp.shape[:-1]
    ri = torch.stack([xp.real, xp.imag], dim=-2).reshape(1, -1, xp.shape[-1])
    ch = ri.shape[1]                                  # 2R
    k = taps.flip(0).to(torch.float32)[None, None].expand(ch, 1, -1)
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        y = F.conv1d(ri, k, stride=stride, groups=ch)[0]
    y = y.reshape(*lead, 2, -1)
    return torch.complex(y[..., 0, :], y[..., 1, :])


def upsample2(x: torch.Tensor, history: torch.Tensor, taps: torch.Tensor):
    """Zero-stuff x2 + half-band filter; returns (y [..., 2N],
    new_history).

    ``x`` is one stream [N] or rows [R, N]; history: [..., len(taps)-1]
    tail of the previous block in the UPSAMPLED domain (carry ``y``'s
    source, i.e. the zero-stuffed stream).
    """
    n = x.shape[-1]
    t = taps.shape[0]
    up = torch.zeros(*x.shape[:-1], 2 * n, dtype=x.dtype, device=x.device)
    up[..., ::2] = x
    xp = torch.cat([history, up], dim=-1)
    return _conv_f32(xp, taps, 1), xp[..., -(t - 1):]


# ---------------------------------------------------------------------------
# anti-alias FIR + decimate-by-2
# (reference: DSP/filter_decimator.h, AVX MAC loops over 16/32/64 taps)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def design_lowpass(n_taps: int, cutoff: float, beta: float) -> tuple:
    """Kaiser-windowed-sinc lowpass; cutoff in cycles/sample (0..0.5)."""
    n = np.arange(n_taps) - (n_taps - 1) / 2.0
    h = 2 * cutoff * np.sinc(2 * cutoff * n)
    h *= np.kaiser(n_taps, beta)
    h /= h.sum()
    return tuple(h.astype(np.float32))


# GUI-selectable filter tiers analogous to the reference's
# Soft/Medium/Sharp/Test presets (filter_decimator.h:29-120): the stream into
# the FIR runs at 2x elementary rate (128/7 ~ 18.29 Msps); the 8 MHz T2
# signal occupies +-3.81 MHz ~ +-0.21 fs, aliases fold in above 0.29 fs.
FIR_PRESETS = {
    "soft": (16, 0.25, 3.0),
    "medium": (32, 0.25, 5.0),
    "sharp": (64, 0.25, 7.0),
    # the reference's Test1/Test2 16-tap equiripple variants (pass 3.7/3.8
    # MHz, stop 5.4 MHz at ~2x elementary) as clean-room Kaiser designs
    "test1": (16, 0.249, 2.6),
    "test2": (16, 0.252, 2.6),
}


def fir_taps(preset: str = "medium") -> np.ndarray:
    n, cut, beta = FIR_PRESETS[preset]
    return np.asarray(design_lowpass(n, cut, beta), dtype=np.float32)


def fir_decimate2(x: torch.Tensor, history: torch.Tensor,
                  taps: torch.Tensor):
    """Overlap-save FIR + decimate by 2.

    x: [N] or rows [R, N] complex (N even); history: [..., len(taps)-1]
    tail of the previous block.  Returns (y [..., N//2], new_history).
    """
    t = taps.shape[0]
    xp = torch.cat([history, x], dim=-1)
    return _conv_f32(xp, taps, 2), xp[..., -(t - 1):]


# ---------------------------------------------------------------------------
# one ingest block, end to end (runtime/stream.py carries the state)
# ---------------------------------------------------------------------------

def frontend_block(raw: torch.Tensor, c1, c2, phase0, freq, mu0, s_hi, s_lo,
                   fir_hist, hb1_hist, hb2_hist, fir: torch.Tensor,
                   hb: torch.Tensor, n_up: int, spur=None):
    """condition -> [notch] -> NCO -> x2 -> x2 -> Farrow -> FIR/2.

    raw: [n_in] complex64 block at the device rate.  ``spur`` is None or
    (phase, omega, a_re, a_im) of the tracked CW spur, notched before the
    NCO (the spur lives in the RAW spectrum; a retune would move it).
    Returns (elem [n_up // 2], fir_hist, hb1_hist, hb2_hist, cond_stats,
    spur_m or None).
    """
    x, cond_stats = iq_condition(raw, c1, c2)
    spur_m = None
    if spur is not None:
        x, spur_m = spur_notch(x, *spur)
    x, _ = nco_derotate(x, phase0, freq)
    x, hb1n = upsample2(x, hb1_hist, hb)           # x2
    x, hb2n = upsample2(x, hb2_hist, hb)           # x4 grid
    up = farrow_resample(x, mu0, s_hi, s_lo, n_up)
    elem, fir_n = fir_decimate2(up, fir_hist, fir)
    return elem, fir_n, hb1n, hb2n, cond_stats, spur_m
