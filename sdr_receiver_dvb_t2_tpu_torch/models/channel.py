"""Channel / front-end impairment simulator (NumPy test fixture).

Converts ideal elementary-rate (64/7 Msps) transmitter output into what an
SDR front-end would deliver: device sample rate, carrier frequency offset,
sampling-clock ppm error, AWGN, DC offset, IQ gain/phase imbalance, and
integer quantization in the reference's raw formats
(reference/src/rx_raw.cpp:60-91 parses these from the filename).
"""
from __future__ import annotations

import dataclasses
import numpy as np

from ..params.modes import SAMPLE_RATE


@dataclasses.dataclass
class ChannelConfig:
    device_rate: float = 10e6       # Msps of the simulated SDR
    cfo_hz: float = 0.0             # carrier frequency offset
    sro_ppm: float = 0.0            # sampling clock error
    snr_db: float | None = None     # None = noiseless
    phase0: float = 0.0
    dc_offset: complex = 0.0
    iq_gain_db: float = 0.0         # Q arm gain error
    iq_phase_deg: float = 0.0       # quadrature phase error
    # static multipath at the ELEMENTARY rate: (delay_samples, complex gain)
    # per path, e.g. a 0 dB SFN echo = ((0, 1.0), (200, 1.0)).  Applied
    # before resampling so delays are in units of T = 7/64 us.
    echoes: tuple = ()
    seed: int = 1234


def impair(iq: np.ndarray, cfg: ChannelConfig) -> np.ndarray:
    """Elementary-rate IQ -> impaired complex64 at cfg.device_rate."""
    rng = np.random.default_rng(cfg.seed)
    if cfg.echoes:
        taps = np.zeros(max(int(d) for d, _ in cfg.echoes) + 1, np.complex128)
        for delay, gain in cfg.echoes:
            taps[int(delay)] += gain
        iq = np.convolve(iq, taps)[:len(iq)]
    ratio = SAMPLE_RATE / (cfg.device_rate * (1.0 + cfg.sro_ppm * 1e-6))

    # high-fidelity fractional resample to device rate: FFT-upsample x8,
    # then cubic on the fine grid (interpolation images < -60 dB; a naive
    # cubic at this rate ratio would cap the fixture's SNR near 17 dB)
    up = 8
    n = len(iq)
    spec = np.fft.fft(iq.astype(np.complex128))
    fine_spec = np.zeros(n * up, dtype=np.complex128)
    half = n // 2
    fine_spec[:half] = spec[:half]
    fine_spec[-(n - half):] = spec[half:]
    fine = np.fft.ifft(fine_spec) * up

    n_out = int(np.floor((n - 3) / ratio))
    p = (1.0 + ratio * np.arange(n_out)) * up
    idx = np.floor(p).astype(np.int64)
    d = p - idx
    xm1, x0 = fine[idx - 1], fine[idx]
    x1, x2 = fine[idx + 1], fine[idx + 2]
    dm1, dp1, dm2 = d - 1.0, d + 1.0, d - 2.0
    y = (xm1 * (-d * dm1 * dm2 / 6.0) + x0 * (dp1 * dm1 * dm2 / 2.0)
         + x1 * (-dp1 * d * dm2 / 2.0) + x2 * (dp1 * d * dm1 / 6.0))

    # CFO + initial phase (at device rate)
    if cfg.cfo_hz or cfg.phase0:
        n = np.arange(n_out)
        y = y * np.exp(1j * (cfg.phase0
                             + 2 * np.pi * cfg.cfo_hz / cfg.device_rate * n))

    if cfg.snr_db is not None:
        sig_p = np.mean(np.abs(y) ** 2)
        noise_p = sig_p / 10 ** (cfg.snr_db / 10)
        noise = (rng.standard_normal(n_out) + 1j * rng.standard_normal(n_out))
        y = y + noise * np.sqrt(noise_p / 2)

    # IQ imbalance: Q arm gain + quadrature phase skew
    if cfg.iq_gain_db or cfg.iq_phase_deg:
        g = 10 ** (cfg.iq_gain_db / 20)
        phi = np.deg2rad(cfg.iq_phase_deg)
        i_arm = y.real
        q_arm = g * (y.imag * np.cos(phi) + y.real * np.sin(phi))
        y = i_arm + 1j * q_arm

    y = y + cfg.dc_offset
    return y.astype(np.complex64)


def quantize(iq: np.ndarray, fmt: str, scale: float = 0.25) -> np.ndarray:
    """complex64 -> interleaved raw samples ('u8' | 's8' | 's16' | 'f32')."""
    x = np.empty(2 * len(iq), dtype=np.float64)
    x[0::2], x[1::2] = iq.real * scale, iq.imag * scale
    if fmt == "u8":
        return np.clip(np.round(x * 128 + 127.5), 0, 255).astype(np.uint8)
    if fmt == "s8":
        return np.clip(np.round(x * 128), -128, 127).astype(np.int8)
    if fmt == "s16":
        return np.clip(np.round(x * 32768), -32768, 32767).astype(np.int16)
    if fmt == "f32":
        return x.astype(np.float32)
    raise ValueError(f"unknown IQ format {fmt!r}")
