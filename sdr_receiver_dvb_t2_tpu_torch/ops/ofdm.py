"""Batched OFDM demodulation: symbol framing, FFT, carrier extraction.

A whole batch of T2 frames is cut into [F, L, symbol_size] symbol blocks and
transformed by one batched ``torch.fft.fft`` (cuFFT on the GPU), and the
guard-interval correlation CFO discriminator is computed for every symbol at
once.  IQ is complex64 throughout.
"""
from __future__ import annotations

import numpy as np
import torch

from ..params import p1 as p1_mod
from ..params.modes import T2Mode


def frame_to_symbols(frames_iq: torch.Tensor, mode: T2Mode) -> torch.Tensor:
    """[..., frame_samples] frame IQ (incl. P1) -> [..., L, symbol_size]."""
    body = frames_iq[..., p1_mod.P1_LEN:p1_mod.P1_LEN
                     + mode.frame_symbols * mode.symbol_size]
    return body.reshape(*frames_iq.shape[:-1], mode.frame_symbols,
                        mode.symbol_size)


def gi_cfo_estimate(symbols: torch.Tensor, mode: T2Mode) -> torch.Tensor:
    """Fine CFO discriminator per symbol, in radians/sample.

    Correlates the symbol tail against the guard-interval head over the
    window [4, GI-4): angle(sum tail * conj(head)) / (2 * fft_size), whose
    sign matches the residual offset.
    """
    g = mode.guard_size
    head = symbols[..., 4:g - 4]
    tail = symbols[..., mode.fft_size + 4:mode.fft_size + g - 4]
    s = torch.sum(tail * head.conj(), dim=-1)
    return torch.angle(s) / (2 * mode.fft_size)


def symbols_to_carriers(symbols: torch.Tensor, mode: T2Mode) -> torch.Tensor:
    """[..., L, symbol_size] -> [..., L, k_total] active carriers."""
    x = symbols[..., mode.guard_size:]
    scale = float(np.sqrt(mode.k_total) / mode.fft_size)
    spec = torch.fft.fft(x, dim=-1) * scale
    # fftshift + crop as a concat of only the two needed slices
    # (k_total > fft_size/2, so the active window always wraps once)
    half = mode.fft_size // 2
    lo = mode.left_nulls
    hi = lo + mode.k_total - half          # columns taken from spec[..., :hi]
    return torch.cat([spec[..., half + lo:], spec[..., :hi]], dim=-1)


def demod_frame(frames_iq: torch.Tensor, mode: T2Mode):
    """Frame IQ [..., frame_samples] -> ([..., L, k_total] carriers,
    [..., L] gi-CFO estimates)."""
    symbols = frame_to_symbols(frames_iq, mode)
    return symbols_to_carriers(symbols, mode), gi_cfo_estimate(symbols, mode)
