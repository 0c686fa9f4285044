"""Acquisition: from raw elementary-rate samples to a fully known T2 mode.

Host-side state machine mirroring the reference's cold-start sequence
(reference/src/DVB_T2/dvbt2_demodulator.cpp:197-237 P1 handling and
:441-504 guard-interval brute force):

1. P1 search (device correlator, ops/p1_detect) -> start position,
   fractional + integer CFO, S1/S2 -> FFT size & SISO/MISO.
2. Guard-interval / bandwidth-extension search: for each GI hypothesis,
   demodulate the P2 symbol(s), equalize against the P2 pilot grid and try
   to decode L1-pre; its CRC32 arbitrates (the reference tries each GI for
   6 frames; here one frame per hypothesis suffices because the whole
   hypothesis scan is vectorized host math).
3. L1-pre fixes GI/PP/EXT/L_F -> decode L1-post -> full PLP configuration.

Everything here is NumPy on a few OFDM symbols: acquisition is rare and
latency-tolerant; the steady-state path stays on the device.  Only the
soft L1 fallback (ops/l1_soft) decodes on the caller's device.
"""
from __future__ import annotations

import dataclasses
import numpy as np

from .. import resolve_device
from ..params import freq_interleaver, l1, l1_fec, pilots, prbs, qam
from ..params.modes import (T2Mode, FftMode, GuardInterval, PilotPattern,
                            Papr, GUARD_FRACTION)

FFT_BY_S2 = {0: FftMode.FFT_2K, 1: FftMode.FFT_8K, 2: FftMode.FFT_4K,
             3: FftMode.FFT_1K, 4: FftMode.FFT_16K, 5: FftMode.FFT_32K}

# GI hypotheses allowed per FFT size (EN 302 755 table 66)
_GI_ALL = [GuardInterval.G1_128, GuardInterval.G1_32, GuardInterval.G1_16,
           GuardInterval.G19_256, GuardInterval.G1_8, GuardInterval.G19_128,
           GuardInterval.G1_4]


def gi_candidates(fft_size: int) -> list[GuardInterval]:
    out = []
    for g in _GI_ALL:
        f = GUARD_FRACTION[g]
        if (fft_size * f.numerator) % f.denominator == 0:
            if fft_size < 8192 and g in (GuardInterval.G19_256,
                                         GuardInterval.G19_128):
                continue
            if fft_size == 32768 and g == GuardInterval.G1_4:
                continue
            out.append(g)
    return out


def _demod_p2(x: np.ndarray, mode: T2Mode, start: int = 0) -> np.ndarray:
    """Elementary samples starting at the first P2 symbol -> P2 carriers.

    ``start`` shifts the FFT windows (may be negative down to -guard_size:
    the window then eats into what was sliced off as the first guard)."""
    out = np.empty((mode.n_p2, mode.k_total), dtype=np.complex64)
    pos = start
    for s in range(mode.n_p2):
        sym = x[pos + mode.guard_size:pos + mode.symbol_size]
        pos += mode.symbol_size
        spec = np.fft.fftshift(np.fft.fft(sym))
        spec /= mode.fft_size / np.sqrt(mode.k_total)
        out[s] = spec[mode.left_nulls:mode.left_nulls + mode.k_total]
    return out


def _first_path_offset(p2_carriers: np.ndarray,
                       mode: T2Mode) -> tuple[int, int]:
    """(timing offset placing the FIRST path at delay ~0, delay spread).

    SFN anchor: the P1 correlator locks onto EITHER transmitter of a
    near-0 dB echo pair (its metric is ambiguous between them), but
    ISI-free FFT placement requires every path delay in [0, GI] — i.e.
    sync to the first path, not the strongest.  Estimate the CIR from the
    P2 pilot estimates (Hann-windowed DFT; P2's every-3rd-carrier grid
    resolves delays to +-Tu/6) and return the earliest delay within
    -11 dB of the strongest."""
    ref = pilots.reference_symbol(mode, 0)
    pidx = np.nonzero(ref != 0)[0]
    h_p = p2_carriers[0][pidx] / ref[pidx]
    gap = int(np.diff(pidx).max())
    dmax = min(mode.guard_size, int(0.45 * mode.fft_size / gap))
    step = max(1, mode.guard_size // 256)
    d = np.arange(-dmax, dmax, step)
    w = np.hanning(len(pidx))
    cir = (h_p * w) @ np.exp(2j * np.pi * np.outer(pidx, d) / mode.fft_size)
    p = np.abs(cir) ** 2
    above = np.nonzero(p >= 0.08 * p.max())[0]
    return int(d[above[0]]), int(d[above[-1]] - d[above[0]])


def _interp_c(k, pidx, vals):
    return np.interp(k, pidx, vals.real) + 1j * np.interp(k, pidx, vals.imag)


def _mmse_interp_c(k, pidx, vals, fftn, guard, reg=2e-2):
    """Banded host LMMSE pilot->carrier interpolation.

    Linear interpolation fails on SFN channels long before the pilot grid
    aliases: a 0 dB in-guard echo rotates H(k) by up to ~2 rad between P2
    pilots.  Per 64-carrier segment this solves the LMMSE weights for a
    uniform delay prior over [-GI/4, GI] (covering post-echoes to the full
    guard plus moderate pre-echo / timing error), using the complex kernel
    E[h(k1)h*(k2)] = sinc(dk*span/Tu) e^{-2pi j dk c/Tu}.  Host-side
    acquisition only; the streaming path's equivalent is the Wiener rows
    of ops/rx_chain._banded_interp_weights."""
    pidx = np.asarray(pidx)
    gap = int(np.diff(pidx).max()) if len(pidx) > 1 else 1
    span = min(1.25 * guard, 0.8 * fftn / gap)
    c = span / 2 - span / 8      # prior window [-span/8, 7*span/8]

    def kern(d):
        return (np.sinc(d * span / fftn)
                * np.exp(-2j * np.pi * d * (c / fftn)))

    out = np.empty(len(k), np.complex128)
    seg, H, n = 64, 16, len(pidx)
    for s0 in range(0, len(k), seg):
        ks = k[s0:s0 + seg]
        a = max(0, np.searchsorted(pidx, ks[0]) - H)
        b = min(n, np.searchsorted(pidx, ks[-1]) + H)
        p = pidx[a:b]
        r_pp = kern(p[:, None] - p[None, :]) + reg * np.eye(len(p))
        r_dp = kern(ks[:, None] - p[None, :])
        out[s0:s0 + seg] = r_dp @ np.linalg.solve(r_pp, vals[a:b])
    return out


def _equalize_p2(carriers: np.ndarray, mode: T2Mode) -> np.ndarray:
    """Pilot-referenced equalize + freq-deinterleave of the P2 symbols.

    MISO: P2 pilots alternate transmit-group-2 polarity per carrier
    (EN 302 755 clause 9.2.5), so the even half estimates h1+h2 and the
    odd half h1-h2; payload pairs then Alamouti-combine (clause 6.4).
    """
    cells = []
    k = np.arange(mode.k_total)
    for s in range(carriers.shape[0]):
        ref = pilots.reference_symbol(mode, s)
        pidx = np.nonzero(ref != 0)[0]
        h_p = carriers[s][pidx] / ref[pidx]
        didx = pilots.data_cell_indices(mode, s)
        if mode.miso:
            inv = pilots.miso_inversion_mask(mode, s)[pidx]
            h_own = _mmse_interp_c(k, pidx[~inv], h_p[~inv],
                                   mode.fft_size, mode.guard_size)
            h_alt = _mmse_interp_c(k, pidx[inv], h_p[inv],
                                   mode.fft_size, mode.guard_size)
            h1 = 0.5 * (h_own + h_alt)
            h2 = 0.5 * (h_own - h_alt)
            r = carriers[s]
            a, b = didx[0::2], didx[1::2]
            d1 = np.maximum(np.abs(h1[a]) ** 2 + np.abs(h2[b]) ** 2, 1e-9)
            d2 = np.maximum(np.abs(h1[b]) ** 2 + np.abs(h2[a]) ** 2, 1e-9)
            data = np.empty(len(didx), np.complex64)
            data[0::2] = (np.conj(h1[a]) * r[a]
                          + h2[b] * np.conj(r[b])) / d1
            data[1::2] = (np.conj(h1[b]) * r[b]
                          - h2[a] * np.conj(r[a])) / d2
        else:
            h = _mmse_interp_c(k, pidx, h_p, mode.fft_size, mode.guard_size)
            eq = carriers[s] * np.conj(h) / np.maximum(np.abs(h) ** 2, 1e-9)
            data = eq[didx]
        perm = freq_interleaver.tx_permutation(mode, len(data), s)
        cells.append(data[perm])
    return np.concatenate(cells)


@dataclasses.dataclass
class AcquisitionResult:
    mode: T2Mode
    l1_pre: l1.L1Pre
    l1_post: l1.L1Post
    p2_cells: np.ndarray
    timing_off: int = 0     # add to the P1 position: first-path alignment
    sfn: bool = False       # measured delay spread demands Wiener rows


def decode_l1_from_p2(cells: np.ndarray, pre: l1.L1Pre, device=None):
    """L1-post decode given equalized P2 cells and a parsed L1-pre.

    Hard-decision systematic slice first (free, matches p2_symbol.cpp:
    514-648); on CRC failure, the soft FEC path (ops/l1_soft: depuncture +
    LDPC BP + BCH, on ``device``), a beyond-reference capability that
    holds acquisition near threshold SNR.
    """
    device = resolve_device(device)
    mod = pre.l1_post_mod
    post_cells = cells[l1.L1_PRE_CELLS:l1.L1_PRE_CELLS + pre.l1_post_size]
    k_sig = pre.l1_post_info_size + 32
    if mod == 0:
        stream = (post_cells.real < 0).astype(np.uint8)
    else:
        from ..params.modes import Constellation
        const = {1: Constellation.QPSK, 2: Constellation.QAM16,
                 3: Constellation.QAM64}.get(mod)
        if const is None:       # reserved L1_POST mod code in a valid pre
            raise l1.L1DecodeError(f"reserved L1_POST modulation {mod}")
        stream = qam.hard_bits(post_cells, const)
    coded = l1_fec.undo_l1_post_interleave(stream, mod)
    info = coded[:k_sig]
    if pre.l1_post_scrambled:
        info = info ^ prbs.l1_scrambler(k_sig)
    post = l1.parse_l1_post_info(info, pre)
    if post is not None:
        return post
    # soft fallback: LLRs through the punctured SHORT_C1_2 code
    from ..ops import l1_soft
    llr_stream = l1_soft.cell_llrs(post_cells, mod)
    llr_coded = l1_fec.undo_l1_post_interleave_soft(llr_stream, mod)
    info = l1_soft.decode_l1_post_fec(llr_coded, k_sig, device)
    if info is None:
        return None
    if pre.l1_post_scrambled:
        info = info ^ prbs.l1_scrambler(k_sig)
    return l1.parse_l1_post_info(info, pre)


def decode_l1_cells(cells: np.ndarray, device=None):
    """Equalized L1 signalling cells -> (pre, post), or None on erasure.

    The steady-state L1 read of the tracker
    (runtime/stream._check_l1_dynamic): hard systematic L1-pre
    parse, soft-FEC fallback near threshold, then the L1-post decode
    (hard + soft fallback).  Raises params.l1.L1DecodeError only for
    malformed-but-CRC-valid signalling; returns None for plain erasure.
    The soft fallback decodes on ``device``.
    """
    device = resolve_device(device)
    pre_bits = (cells[:l1.L1_PRE_CELLS].real < 0).astype(np.uint8)
    pre = l1.parse_l1_pre(l1_fec.decode_l1_pre_systematic(pre_bits))
    if pre is None:
        from ..ops import l1_soft
        info = l1_soft.decode_l1_pre_fec(
            l1_soft.cell_llrs(cells[:l1.L1_PRE_CELLS], 0), device)
        pre = None if info is None else l1.parse_l1_pre(info)
    if pre is None:
        return None
    post = decode_l1_from_p2(cells, pre, device)
    return None if post is None else (pre, post)


def acquire_mode(elem: np.ndarray, s1: int, s2_field1: int, device=None
                 ) -> AcquisitionResult | None:
    """Blind GI/EXT search + L1 decode.

    elem: elementary-rate samples starting right AFTER a detected P1
    symbol (CFO already corrected).  Returns None if no hypothesis decodes
    an L1-pre with valid CRC.  The soft L1 fallback decodes on ``device``.
    """
    device = resolve_device(device)
    # S1: 0/1 = T2 SISO/MISO, 3/4 = T2-Lite SISO/MISO (all beyond the
    # reference, whose MISO receive path is vestigial and whose
    # T2-Lite-only code rates are never wired up)
    if s1 not in (0, 1, 3, 4):
        return None
    miso = s1 in (1, 4)
    lite = s1 in (3, 4)
    fft_mode = FFT_BY_S2.get(s2_field1)
    if fft_mode is None:
        return None

    from ..params.modes import FFT_SIZE, MISO_PILOT_PATTERNS
    fft_size = FFT_SIZE[fft_mode]
    if lite and fft_size not in (2048, 4096, 8192, 16384):
        return None             # annex I: T2-Lite is 2K/4K/8K/16K only
    # the scan mode's PP is irrelevant for P2 demod (P2 pilot geometry is
    # PP-independent); pick a legal one so the mode is constructible
    scan_pp = (sorted(MISO_PILOT_PATTERNS[fft_size])[0] if miso
               else PilotPattern.PP7)

    for gi in gi_candidates(fft_size):
        for ext in ([False] if fft_size < 8192 else [True, False]):
            mode = T2Mode(fft_mode=fft_mode, guard=gi,
                          pilot_pattern=scan_pp, miso=miso, lite=lite,
                          extended_carriers=ext, n_data_symbols=1)
            need = mode.n_p2 * mode.symbol_size
            if len(elem) < need:
                continue
            carriers = _demod_p2(elem, mode)
            # re-anchor to the channel's first path (SFN: the P1 position
            # may be the echo's); a wrong GI hypothesis yields a garbage
            # offset but would have failed its L1 CRC regardless
            off, spread = _first_path_offset(carriers, mode)
            off = int(np.clip(off, -mode.guard_size + 1,
                              len(elem) - need))
            if abs(off) > 8:
                carriers = _demod_p2(elem, mode, off)
            else:
                off = 0
            cells = _equalize_p2(carriers, mode)
            pre_bits = (cells[:l1.L1_PRE_CELLS].real < 0).astype(np.uint8)
            pre = l1.parse_l1_pre(l1_fec.decode_l1_pre_systematic(pre_bits))
            if pre is None:
                # soft fallback: BPSK LLRs through the punctured SHORT_C1_4
                # code (ops/l1_soft) — holds acquisition near threshold
                from ..ops import l1_soft
                info = l1_soft.decode_l1_pre_fec(
                    l1_soft.cell_llrs(cells[:l1.L1_PRE_CELLS], 0), device)
                pre = None if info is None else l1.parse_l1_pre(info)
            if pre is None:
                continue
            if GuardInterval(pre.guard_interval) != gi:
                continue
            if bool(pre.bwt_ext) != ext:
                continue
            full_mode = T2Mode(
                fft_mode=fft_mode, guard=gi,
                pilot_pattern=PilotPattern(pre.pilot_pattern),
                extended_carriers=ext, papr=Papr(pre.papr), miso=miso,
                lite=lite, n_data_symbols=pre.num_data_symbols)
            post = decode_l1_from_p2(cells, pre, device)
            if post is None:
                continue
            # SFN decision: does the measured delay spread rotate H(k)
            # between the DATA symbols' scattered pilots faster than the
            # cheap 2-tap linear rows can follow (~phi^2/8 amplitude
            # error)?  Above ~0.35 rad force the Wiener/CSI/CIR plan even
            # on modes whose pilot reach covers the guard (e.g. a
            # 250-sample echo in 32K GI1/128 PP7 rotates 4.6 rad); the
            # clean-channel CIR main lobe measures ~0.1-0.2 rad and keeps
            # the linear plan.  Modes already reach-gated ignore the flag.
            gap = full_mode.dx * full_mode.dy
            sfn = (2.0 * np.pi * spread * gap / full_mode.fft_size) > 0.35
            return AcquisitionResult(mode=full_mode, l1_pre=pre,
                                     l1_post=post, p2_cells=cells,
                                     timing_off=off, sfn=sfn)
    return None
