"""Pilot tables for the channel equalizer (host-side plan builder).

EqualizerPlan extracts, per OFDM symbol, the pilot positions / reference
signs / amplitudes (the reference computes these on the fly while walking
carriers, reference/src/DVB_T2/data_symbol.cpp:98-318,
p2_symbol.cpp:76-280) plus the masks behind the per-symbol tracking
discriminators: common phase offset (sum of pilot phasors per
half-spectrum, data_symbol.cpp:300-303) and the sampling-rate-offset
discriminator over always-present pilots (data_symbol.cpp:165,263-265).

The device-side equalization itself lives in ops/rx_chain.equalize_plane
(complex-domain banded-matmul interpolation); sro_coefficient calibrates
the SRO discriminator's scale for the tracking loop.
"""
from __future__ import annotations

import functools

import numpy as np

from ..params import pilots
from ..params.modes import T2Mode


class EqualizerPlan:
    """Precomputed per-frame index tables (NumPy -> device constants)."""

    def __init__(self, mode: T2Mode):
        self.mode = mode
        L, K = mode.frame_symbols, mode.k_total
        pilot_idx, ref_vals, amp_vals = [], [], []
        n_pilots = []
        always_pilot = None

        for l in range(L):
            cmap = pilots.carrier_map_for_symbol(mode, l)
            ref = pilots.reference_symbol(mode, l)
            is_pilot = ref != 0
            pidx = np.nonzero(is_pilot)[0]
            n_pilots.append(len(pidx))
            pilot_idx.append(pidx)
            ref_vals.append(np.sign(ref[pidx]).astype(np.float32))
            amp_vals.append(np.abs(ref[pidx]).astype(np.float32))
            ap = is_pilot if always_pilot is None else (always_pilot & is_pilot)
            always_pilot = ap

        self.p_max = max(n_pilots)
        self.n_pilots = np.array(n_pilots)

        def pad(rows, width, fill):
            out = np.full((L, width), fill, dtype=rows[0].dtype)
            for i, r in enumerate(rows):
                out[i, :len(r)] = r
            return out

        self.pilot_idx = np.asarray(pad(pilot_idx, self.p_max, 0).astype(np.int32))
        self.ref_vals = np.asarray(pad(ref_vals, self.p_max, np.float32(1)))
        self.amp_vals = np.asarray(pad(amp_vals, self.p_max, np.float32(1)))
        # mask of pilots valid per symbol
        self.pilot_valid = np.asarray(
            np.arange(self.p_max)[None, :] < self.n_pilots[:, None])
        # first/second spectrum half membership of each pilot
        half = K // 2
        self.pilot_first_half = np.asarray(
            pad([(p < half) for p in pilot_idx], self.p_max, False))

        # continual pilots present in every symbol, for the SRO discriminator
        ap_idx = np.nonzero(always_pilot)[0]
        if mode.miso:
            # keep only carriers whose group-2 polarity is the same in
            # every symbol: the discriminator multiplies symbol pairs at
            # one carrier, so a constant inversion cancels, but a P2/data
            # polarity flip would inject a pi phase step into the estimate
            inv = np.stack([pilots.miso_inversion_mask(mode, l)[ap_idx]
                            for l in range(L)])
            ap_idx = ap_idx[(inv == inv[0]).all(axis=0)]
        self.sro_idx = np.asarray(ap_idx.astype(np.int32))
        self.sro_first_half = np.asarray(ap_idx < half)
        # dense reference values at those carriers per symbol
        sro_ref = np.stack([pilots.reference_symbol(mode, l)[ap_idx]
                            for l in range(L)])
        self.sro_ref = np.asarray(np.sign(sro_ref).astype(np.float32))



@functools.lru_cache(maxsize=None)
def get_plan(mode: T2Mode) -> EqualizerPlan:
    return EqualizerPlan(mode)


@functools.lru_cache(maxsize=None)
def sfn_reach_gated(mode: T2Mode) -> bool:
    """True if the mode's DEFAULT interpolation plan is already SFN-grade.

    Mirrors the per-row reach test in ops/rx_chain.EqTables: any row whose
    own-pilot grid resolves less delay than the guard interval forces the
    whole mode onto temporal-union + Wiener rows unconditionally.  Modes
    where this returns False default to cheap 2-tap linear rows and rely
    on the acquisition-time delay-spread measurement (``RxConfig.sfn``) to
    escalate when the channel actually carries long echoes."""
    if mode.miso:
        return True          # MISO builds its own (union-equivalent) plan
    ep = get_plan(mode)
    for l in range(mode.frame_symbols):
        pidx = np.asarray(ep.pilot_idx[l][:int(ep.n_pilots[l])])
        if mode.fft_size // int(np.diff(pidx).max()) < mode.guard_size:
            return True
    return False


@functools.lru_cache(maxsize=None)
def sro_coefficient(mode: T2Mode) -> float:
    """d(sro discriminator)/d(sampling-rate offset), computed numerically.

    A sampling clock offset ``sro`` slips the FFT window by
    ``l * symbol_size * sro`` samples at symbol l, i.e. a per-carrier phase
    ramp.  This evaluates the same discriminator as rx_chain.equalize_plane on a
    synthetic ramp so the tracking loop (runtime/stream.py) can normalize
    the estimate without hand-derived sign/scale conventions.
    """
    plan = get_plan(mode)
    sro = 1e-6
    k = np.asarray(plan.sro_idx)
    bin_rel = (mode.left_nulls + k) - mode.fft_size / 2.0
    L = mode.frame_symbols
    vals = []
    for l in range(L):
        tau = l * mode.symbol_size * sro
        vals.append(np.exp(2j * np.pi * bin_rel * tau / mode.fft_size))
    est = np.stack(vals)
    # same CPO-derotated formulation as rx_chain.equalize_plane: z phasors
    # are derotated by their sum before the half-spectrum difference
    z = est[1:] * np.conj(est[:-1])
    zs = np.sum(z, axis=1, keepdims=True)
    drift = (z * np.conj(zs / np.maximum(np.abs(zs), 1e-12))).imag
    fh = np.asarray(plan.sro_first_half)[None]
    d1 = np.sum(np.where(fh, drift, 0), axis=1)
    d2 = np.sum(np.where(fh, 0, drift), axis=1)
    pwr = np.mean(np.abs(est) ** 2, axis=1)
    d = (d2 - d1) / np.maximum(pwr[1:] * est.shape[1], 1e-12)
    return float(np.mean(d) / sro)
