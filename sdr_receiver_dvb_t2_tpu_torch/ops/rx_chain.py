"""Fused frame-batch receive chain: OFDM demod -> equalize -> demap -> LLR.

Two structural choices carry over from the JAX chain:

1. **Channel interpolation as a banded matmul.**  Interpolation between
   pilots is a linear operator; for each distinct pilot layout the
   pilot->carrier weights are stored banded per 256-carrier segment
   ([n_seg, WIN, SEG]) and the per-symbol channel estimate is one pilot
   window gather plus one batched matmul per layout group.
2. **One composed gather.**  Frequency deinterleave, the L1/PLP slice and
   the time+cell deinterleave are all static permutations; their
   composition maps each FEC-block cell straight to a carrier of the
   equalized [L, K] plane.

Three equalizer plans, all built on the host in float64 and cast to
float32 exactly as the JAX package builds them:

* SISO, linear rows: 2-tap interpolation between a symbol's own pilots.
* SFN (single-frequency network: a second transmitter seen as an echo up
  to the guard interval long): LMMSE ("Wiener") rows for a guard-wide
  delay prior, temporal-union pilot sets where a symbol's own pilots
  cannot resolve the guard, a per-symbol common-phase derotation
  (``ph_rot``), per-carrier channel power (``csi``) for the demapper and
  a delay profile (``cir_p``) for the stream's first-path timing loop.
  Modes whose own pilots fall short of the guard always take this plan;
  others take it when acquisition measures a long echo (``sfn=True``).
* MISO (Alamouti, EN 302 755 clause 6.4 / 9.2.2.3): two interpolated
  planes of opposite pilot polarity separate the two transmit groups'
  channels, and carrier-order payload pairs are combined; the partner of
  each cell is one gather over ``pair_idx``.

Precision: the port keeps complex64 end to end.  The JAX chain rounds the
carrier plane, the equalized plane and ``csi`` to bf16; the port does
not, so its cells differ from the JAX ones by that rounding (about 2^-9
relative), which moves an int8 LLR by at most a step or two.  The banded
products and the delay-profile product run in full float32 whatever the
process's TF32 setting (``_f32_products``).
"""
from __future__ import annotations

import contextlib
import functools
import re

import numpy as np
import torch

from ..params import freq_interleaver, pilots
from ..params.modes import T2Mode, PlpConfig
from . import equalizer as eq_mod
from . import llr as llr_mod
from . import ofdm
from .ldpc import kernel_bit_order


def _banded_interp_weights(K: int, seg: int, sets: list):
    """Banded interpolation weight tables for per-symbol pilot sets.

    ``sets``: one dict per output symbol row l with keys
      src    — frame symbol whose carrier plane holds the pilots (a scalar,
               or one per pilot for the SFN temporal-union sets; the MISO
               plan points a data symbol at its neighbour's pilots),
      pidx   — sorted pilot carrier indices (int64),
      sign   — TX1 reference sign per pilot,
      amp    — reference amplitude per pilot,
      wiener — optional (center, span, fft_size, noise) LMMSE design;
               absent or None selects 2-tap linear weights.
    Returns (group_syms, regroup, weights) with one weights entry
    (win_idx [Lg, S, Wg] int32, si_re [Lg, S, Wg], si_im [Lg, S, Wg] or
    None, wband [S, Wg, SEG], rot (re [K], im [K]) or None) per group of
    rows sharing a pilot layout and design.

    Carrier k interpolates between pilot ordinals lo(k) and lo(k)+1, and lo
    is monotone in k, so a segment of SEG consecutive carriers touches only
    a narrow window of pilot ordinals.  win_idx[s, w] holds the flat
    carrier index of pilot ordinal o(s)+w, so pilot extraction and the
    per-segment window gather are one index table; the reference sign and
    amplitude normalization fold into si, with padded slots zeroed.

    Wiener rows: a near-0 dB SFN echo at delay d rotates H(k) by
    2*pi*d*Dx/Tu between adjacent pilots, far past what 2-tap linear
    weights follow.  Those rows hold the per-carrier LMMSE interpolator
    for a uniform delay prior of width ``span`` centred at ``center``:
    pilots are pre-rotated by e^{+2pi j k c/Tu} (folded into the complex
    si), which makes the channel autocorrelation the real kernel
    sinc(dk*span/Tu), and the outputs are post-rotated back by
    e^{-2pi j k c/Tu} (``rot``).  The weights solve
    (R_pp + noise*I) W = R_dp per segment in float64.
    """
    L = len(sets)
    n_seg = -(-K // seg)
    groups: dict[tuple, list[int]] = {}
    for l in range(L):
        groups.setdefault((sets[l]["pidx"].tobytes(),
                           sets[l].get("wiener")), []).append(l)
    group_syms = [np.array(v, np.int32) for v in groups.values()]
    order = np.concatenate(group_syms)
    regroup = np.empty(L, np.int64)
    regroup[order] = np.arange(L)                   # undo group concat order

    weights = []
    for syms in group_syms:
        s0 = sets[int(syms[0])]
        pidx = s0["pidx"]
        wiener = s0.get("wiener")
        n_pil = len(pidx)
        k = np.arange(K)
        lo = np.clip(np.searchsorted(pidx, k) - 1, 0, n_pil - 2)
        if wiener is None:
            span = np.maximum(pidx[lo + 1] - pidx[lo], 1)
            frac = (k - pidx[lo]) / span
            win = 0
            for s in range(n_seg):
                seg_lo = lo[s * seg:(s + 1) * seg]
                win = max(win, int(seg_lo.max() - seg_lo.min()) + 2)
            win = -(-win // 8) * 8
            o_idx = np.zeros(n_seg, np.int64)
            wband = np.zeros((n_seg, win, seg), np.float32)
            for s in range(n_seg):
                k0 = s * seg
                k1 = min(k0 + seg, K)
                seg_lo = lo[k0:k1]
                o = int(seg_lo.min())
                o_idx[s] = o
                cols = np.arange(k1 - k0)
                wband[s, seg_lo - o, cols] = 1.0 - frac[k0:k1]
                wband[s, seg_lo - o + 1, cols] = frac[k0:k1]
            ords = np.minimum(o_idx[:, None] + np.arange(win)[None],
                              n_pil - 1)                   # [S, Wg]
            valid = (o_idx[:, None] + np.arange(win)[None]) < n_pil
        else:
            center, dspan, fftn, noise = wiener
            H = 12                     # extra MMSE taps on each side
            win = 0
            for s in range(n_seg):
                seg_lo = lo[s * seg:(s + 1) * seg]
                win = max(win,
                          int(seg_lo.max() - seg_lo.min()) + 2 + 2 * H)
            win = min(-(-win // 8) * 8, n_pil)
            o_idx = np.zeros(n_seg, np.int64)
            wband = np.zeros((n_seg, win, seg), np.float32)
            for s in range(n_seg):
                k0 = s * seg
                k1 = min(k0 + seg, K)
                o = int(np.clip(lo[k0:k1].min() - (H - 1),
                                0, n_pil - win))
                o_idx[s] = o
                p = pidx[o:o + win].astype(np.float64)
                r_pp = np.sinc((p[:, None] - p[None, :]) * (dspan / fftn))
                r_dp = np.sinc((p[:, None] - np.arange(k0, k1)[None])
                               * (dspan / fftn))
                wband[s, :, :k1 - k0] = np.linalg.solve(
                    r_pp + noise * np.eye(win), r_dp)
            ords = o_idx[:, None] + np.arange(win)[None]   # all in range
            valid = np.ones_like(ords, bool)
        flat = np.stack([np.broadcast_to(sets[int(l)]["src"],
                                         pidx.shape).astype(np.int64) * K
                         + pidx for l in syms])             # [Lg, n_pil]
        win_idx = flat[:, ords].astype(np.int32)            # [Lg, S, Wg]
        sign = np.stack([sets[int(l)]["sign"][ords] for l in syms])
        inv_amp = np.stack([1.0 / sets[int(l)]["amp"][ords] for l in syms])
        s_amp = sign * inv_amp * valid[None]
        if wiener is None:
            si_re, si_im, rot = s_amp.astype(np.float32), None, None
        else:
            ph = 2.0 * np.pi * pidx[ords] * (center / fftn)  # [S, Wg]
            si_re = (s_amp * np.cos(ph)[None]).astype(np.float32)
            si_im = (s_amp * np.sin(ph)[None]).astype(np.float32)
            kr = -2.0 * np.pi * np.arange(K) * (center / fftn)
            rot = (np.cos(kr).astype(np.float32),
                   np.sin(kr).astype(np.float32))
        weights.append((win_idx, si_re, si_im, wband, rot))
    return group_syms, regroup, weights


class EqTables:
    """Mode-only equalizer tables (shared by every PLP of a mux).

    ``sfn=True`` puts the Wiener/CSI/CIR plan on a mode whose default plan
    is linear: the acquisition's delay-spread measurement asks for it when
    it sees an echo that 2-tap linear weights cannot follow."""

    def __init__(self, mode: T2Mode, sfn: bool = False):
        self.mode = mode
        self.sfn = bool(sfn)
        L, K = mode.frame_symbols, mode.k_total
        self.eq_plan = eq_mod.get_plan(mode)
        ep = self.eq_plan
        self.seg = 256

        def full_set(l):
            n = int(ep.n_pilots[l])
            return dict(src=l,
                        pidx=np.asarray(ep.pilot_idx[l][:n]).astype(np.int64),
                        sign=np.asarray(ep.ref_vals[l][:n]),
                        amp=np.asarray(ep.amp_vals[l][:n]))

        self.ph_rot = None
        self.cir_tab = None
        self.cir_d = None
        if not mode.miso:
            sets = [full_set(l) for l in range(L)]
            # a row interpolating from its own pilots resolves delay spread
            # only up to fft_size / (largest pilot gap); where that falls
            # short of the guard, union the row's pilots with those of a
            # centred Dy-symbol window (per-pilot src; duplicates resolve
            # to the nearest symbol), which restores the reach to ~Tu/Dx
            need = [mode.fft_size // int(np.diff(s["pidx"]).max())
                    < mode.guard_size for s in sets]
            h = (mode.dy + 1) // 2
            for l in range(L):
                if not need[l]:
                    continue
                lo = max(0, min(l - h, L - (2 * h + 1)))
                window = sorted(range(lo, min(L, lo + 2 * h + 1)),
                                key=lambda s: (abs(s - l), s - l))
                cat = {key: np.concatenate([full_set(s)[key]
                                            for s in window])
                       for key in ("pidx", "sign", "amp")}
                cat["src"] = np.concatenate(
                    [np.full(int(ep.n_pilots[s]), s, np.int64)
                     for s in window])
                _, first = np.unique(cat["pidx"], return_index=True)
                sets[l] = {key: v[first] for key, v in cat.items()}
            if any(need) or self.sfn:
                # Wiener rows on every row, for a delay prior of
                # [-dspan/8, 7*dspan/8] (anchored just below delay 0 by the
                # first-path timing loop, reaching toward the guard as far
                # as the pilot grid is alias-free)
                for st in sets:
                    gap = int(np.diff(st["pidx"]).max())
                    dspan = min(mode.guard_size + mode.guard_size // 2,
                                int(0.85 * mode.fft_size / gap))
                    st["wiener"] = (dspan / 2 - dspan / 8, dspan,
                                    mode.fft_size, 1e-2)
                # per-symbol common-phase derotation on the continual
                # pilots, so that the temporal union mixes phase-consistent
                # pilots under residual CFO
                sro_idx = np.asarray(ep.sro_idx)
                ph_rot = np.zeros((L, K), np.float32)
                for l in range(L):
                    ph_rot[l, sro_idx] = np.sign(
                        pilots.reference_symbol(mode, l)[sro_idx])
                self.ph_rot = ph_rot
                # delay-profile probe for the first-path timing loop
                # (runtime/stream.py): cir(d) = sum_k hann(k) h(k)
                # e^{+2pi j k d/Tu} on a coarse grid around [0, GI]; Hann
                # keeps truncation sidelobes near -31 dB, below the loop's
                # -11 dB first-path threshold
                dstep = max(2, mode.guard_size // 128)
                d = np.arange(-(mode.guard_size // 2),
                              mode.guard_size + dstep, dstep)
                hann = np.hanning(K)
                ang = 2.0 * np.pi * np.outer(np.arange(K),
                                             d) / mode.fft_size
                self.cir_d = d
                self.cir_tab = (
                    (hann[:, None] * np.cos(ang)).astype(np.float32),
                    (hann[:, None] * np.sin(ang)).astype(np.float32))
            self.group_syms, self.regroup, self.weights = \
                _banded_interp_weights(K, self.seg, sets)
        else:
            self._build_miso(L, K, full_set)

        # dense +-1 sign masks for the common-phase-offset discriminator
        # (sum of pilot phasors per half-spectrum); MISO keeps only the
        # pilots group 2 does not invert (an inverted pilot carries h1-h2)
        ph1 = np.zeros((L, K), np.float32)
        ph2 = np.zeros((L, K), np.float32)
        half = K // 2
        for l in range(L):
            n_pil = int(ep.n_pilots[l])
            pidx = np.asarray(ep.pilot_idx[l][:n_pil])
            sign = np.asarray(ep.ref_vals[l][:n_pil])
            if mode.miso:
                keep = ~pilots.miso_inversion_mask(mode, l)[pidx]
                pidx, sign = pidx[keep], sign[keep]
            fh = pidx < half
            ph1[l, pidx[fh]] = sign[fh]
            ph2[l, pidx[~fh]] = sign[~fh]
        self.ph_mask = (ph1, ph2)

    def _build_miso(self, L, K, full_set):
        """MISO channel separation plans (EN 302 755 clause 9.2.2.3).

        Group 2 inverts pilot subsets, so a pilot reads h1 + h2 or h1 - h2
        after TX1-reference normalization.  Two interpolated planes:
        ``weights`` from each symbol's own polarity (data symbols: the
        scattered pilots' polarity, which alternates per symbol; P2/FC:
        the even, non-inverted carriers) and ``weights_alt`` from the
        opposite one (data symbols: the temporal partner symbol's own
        pilots; P2/FC: the odd carriers).  h1 = (own + alt)/2 and
        h2 = o_sign (own - alt)/2, o_sign[l] = +1 where the own plane is
        the non-inverted one.
        """
        mode = self.mode
        own_sets, alt_sets = [], []
        o_sign = np.ones(L, np.float32)
        n_p2 = mode.n_p2
        last_reg = L - 1 - (1 if mode.has_fc else 0)
        if last_reg <= n_p2:
            raise ValueError("MISO needs at least 2 regular data symbols")
        for l in range(L):
            fs = full_set(l)
            inv = pilots.miso_inversion_mask(mode, l)[fs["pidx"]]

            def sub(s, keep):
                return dict(src=s["src"], pidx=s["pidx"][keep],
                            sign=s["sign"][keep], amp=s["amp"][keep])
            if l < n_p2 or (mode.has_fc and l == L - 1):
                own_sets.append(sub(fs, ~inv))
                alt_sets.append(sub(fs, inv))
            else:
                # scattered pilots sit at k = dx*(l mod dy) (mod dx*dy), so
                # the (k//dx) parity is the l parity (dy is even for every
                # pattern); edge pilots follow the same l % 2 rule
                sp_inv = bool(l % 2)
                own_sets.append(sub(fs, inv == sp_inv))
                o_sign[l] = -1.0 if sp_inv else 1.0
                partner = l + 1 if l < last_reg else l - 1
                pfs = full_set(partner)
                pinv = pilots.miso_inversion_mask(mode, partner)[pfs["pidx"]]
                p_sp_inv = bool(partner % 2)
                alt_sets.append(dict(sub(pfs, pinv == p_sp_inv),
                                     src=partner))
        self.group_syms, self.regroup, self.weights = \
            _banded_interp_weights(K, self.seg, own_sets)
        self.group_syms_alt, self.regroup_alt, self.weights_alt = \
            _banded_interp_weights(K, self.seg, alt_sets)
        self.o_sign = o_sign[:, None]

        # Alamouti pairs: payload cells pair with their carrier-order
        # neighbour within the symbol (MISO encoding follows frequency
        # interleaving, clause 6.4); pilots pair with themselves with sign
        # 0, so they add nothing to the combine
        pair = np.arange(L * K, dtype=np.int64).reshape(L, K)
        psign = np.zeros((L, K), np.float32)
        for l in range(L):
            didx = pilots.data_cell_indices(mode, l)
            if len(didx) % 2:
                raise ValueError(f"symbol {l}: odd number of data cells")
            a, b = didx[0::2], didx[1::2]
            pair[l, a] = l * K + b
            pair[l, b] = l * K + a
            psign[l, a] = 1.0
            psign[l, b] = -1.0
        self.pair_idx = pair.reshape(-1).astype(np.int32)
        self.pair_sign = psign

        # common-phase derotation on the same carriers in every symbol (a
        # per-symbol pilot set would carry a set-dependent phase bias that
        # leaks between h1 and h2): the consistent-polarity continual
        # pilots, the non-inverted ones only
        sro_idx = np.asarray(self.eq_plan.sro_idx)
        keep = ~pilots.miso_inversion_mask(mode, 0)[sro_idx]
        rot_idx = sro_idx[keep if keep.any() else slice(None)]
        ph_rot = np.zeros((L, K), np.float32)
        for l in range(L):
            ph_rot[l, rot_idx] = np.sign(
                pilots.reference_symbol(mode, l)[rot_idx])
        self.ph_rot = ph_rot


@functools.lru_cache(maxsize=8)
def get_eq_tables(mode: T2Mode, sfn: bool = False) -> EqTables:
    if sfn and eq_mod.sfn_reach_gated(mode):
        return get_eq_tables(mode, False)   # already Wiener: one table set
    return EqTables(mode, sfn)


class ChainPlan:
    """All tables for frames -> LLR, one T2Mode + PLP config (host numpy).

    ``to_device`` moves them to a device once; the receiver keeps that
    copy for its lifetime.
    """

    def __init__(self, mode: T2Mode, plp: PlpConfig, n_fec: int, n_ti: int,
                 l1_cells: int, sfn: bool = False):
        self.mode = mode
        self.plp = plp
        self.n_fec = n_fec
        self.l1_cells = l1_cells
        L, K = mode.frame_symbols, mode.k_total
        self.eq = get_eq_tables(mode, sfn)
        self.eq_plan = self.eq.eq_plan
        self.demap = llr_mod.get_plan(plp, n_fec, n_ti)

        # ---- composed cell gather: FEC cell -> flat [L*K] position ----
        pay2carrier = []
        for l in range(L):
            didx = pilots.data_cell_indices(mode, l)
            n_cells = len(didx)
            take = n_cells
            if mode.has_fc and l == L - 1:
                take = mode.c_fc
            h = freq_interleaver.tx_permutation(mode, n_cells, l)
            pay2carrier.append(l * K + didx[h[:take]])
        pay2carrier = np.concatenate(pay2carrier)
        assert len(pay2carrier) == mode.frame_cells, (
            len(pay2carrier), mode.frame_cells)
        # carrier positions of the leading payload cells (L1-pre/post)
        self.sig_idx = pay2carrier[:l1_cells].astype(np.int32)
        stream = pay2carrier[l1_cells:l1_cells
                             + n_fec * plp.cells_per_fec_block]
        self.cell_idx = stream[self.demap.ti_gather].astype(np.int32)

        # bit deinterleave + LDPC-kernel row order folded into one static
        # row gather on the LLR stream ...
        self.bit_rows = self.demap.bit_gather[
            kernel_bit_order(plp.ldpc_table_name)].astype(np.int32)
        # ... or, when the composed permutation is block/roll-structured,
        # strided slices + rolls of the demap bit planes
        self.bit_blocks = self._decompose_bit_rows()

    def _decompose_bit_rows(self):
        """bit_rows as concat of rolled stride-g slices of demap planes.

        Returns list of (plane, phase, step, roll, length) with
        rows == concat_j [ (phase + step*((roll + i) % L)) * eta + plane ]
        cell-index form, or None when no such structure exists (QPSK's
        staircase-only map, NORMAL C3_5's different twist set).
        """
        from math import gcd
        rows = self.bit_rows.astype(np.int64)
        eta = self.plp.bits_per_cell
        n_cells = len(rows) // eta
        cell, bit = rows // eta, rows % eta
        blocks = np.split(np.arange(len(rows)),
                          np.nonzero(np.diff(bit))[0] + 1)
        out = []
        for blk in blocks:
            if len(blk) < 2:
                return None
            b = int(bit[blk[0]])
            c = cell[blk]
            s = int((c[1] - c[0]) % n_cells)
            if s == 0 or not np.array_equal(
                    (c[0] + s * np.arange(len(blk))) % n_cells, c):
                return None
            g = gcd(s, n_cells)
            if s // g != 1 or len(blk) != n_cells // g:
                return None
            phase = int(c[0] % g)
            out.append((b, phase, g, int((c[0] - phase) // g), len(blk)))
        return out

    def arrays(self) -> dict:
        """The plan's tables as numpy arrays, keyed by name (the state that
        models.receiver.plan_from_numpy takes).  Interpolation groups are
        ``w{j}_*`` (``walt{j}_*`` for MISO's second plane), with ``si_im``
        and ``rot_re``/``rot_im`` on Wiener rows only."""
        eq = self.eq
        out = dict(cell_idx=self.cell_idx, bit_rows=self.bit_rows,
                   sig_idx=self.sig_idx,
                   ph_mask1=eq.ph_mask[0], ph_mask2=eq.ph_mask[1],
                   regroup=eq.regroup,
                   sro_idx=np.asarray(self.eq_plan.sro_idx),
                   sro_ref=np.asarray(self.eq_plan.sro_ref),
                   sro_first_half=np.asarray(self.eq_plan.sro_first_half))
        _put_weights(out, "w", eq.weights)
        if eq.ph_rot is not None:
            out["ph_rot"] = eq.ph_rot
        if eq.cir_tab is not None:
            out["cir_tab_re"], out["cir_tab_im"] = eq.cir_tab
            out["cir_d"] = eq.cir_d
        if self.mode.miso:
            _put_weights(out, "walt", eq.weights_alt)
            out.update(regroup_alt=eq.regroup_alt, o_sign=eq.o_sign,
                       pair_idx=eq.pair_idx, pair_sign=eq.pair_sign)
        return out

    def to_device(self, device) -> dict:
        """The device copy of the plan, built from :meth:`arrays`."""
        return consts_from_arrays(self.arrays(), device)


def _put_weights(out: dict, prefix: str, weights) -> None:
    for j, (wi, si_re, si_im, wb, rot) in enumerate(weights):
        out[f"{prefix}{j}_win_idx"] = wi
        out[f"{prefix}{j}_si_re"] = si_re
        out[f"{prefix}{j}_wband"] = wb
        if si_im is not None:
            out[f"{prefix}{j}_si_im"] = si_im
        if rot is not None:
            out[f"{prefix}{j}_rot_re"], out[f"{prefix}{j}_rot_im"] = rot


_GROUP_KEY = re.compile(r"(w|walt)(\d+)_")


def consts_from_arrays(arrays: dict, device) -> dict:
    """Numpy plan arrays -> device tensors (index tables as int64).

    Each interpolation group becomes (win_idx, si, wband, rot): si is real
    on linear rows and complex on Wiener rows, rot is complex or None."""
    def t(a):
        a = np.asarray(a)
        if a.dtype.kind in "iu":
            a = a.astype(np.int64)
        return torch.as_tensor(a, device=device)

    consts = {}
    groups: dict[str, dict[int, dict]] = {}
    for k, v in arrays.items():
        m = _GROUP_KEY.match(k)
        if m:
            groups.setdefault(m[1], {}).setdefault(int(m[2]), {})[
                k[m.end():]] = v
        elif not k.startswith("cir_tab"):
            consts[k] = t(v)
    for prefix, by_j in groups.items():
        consts[prefix] = []
        for j in range(len(by_j)):
            g = by_j[j]
            si = t(g["si_re"])
            if "si_im" in g:
                si = torch.complex(si, t(g["si_im"]))
            rot = (torch.complex(t(g["rot_re"]), t(g["rot_im"]))
                   if "rot_re" in g else None)
            consts[prefix].append((t(g["win_idx"]), si, t(g["wband"]), rot))
    if "cir_tab_re" in arrays:
        consts["cir_tab"] = (t(arrays["cir_tab_re"]),
                             t(arrays["cir_tab_im"]))
    return consts


@functools.lru_cache(maxsize=8)
def get_plan(mode: T2Mode, plp: PlpConfig, n_fec: int, n_ti: int,
             l1_cells: int, sfn: bool = False) -> ChainPlan:
    if sfn and eq_mod.sfn_reach_gated(mode):
        return get_plan(mode, plp, n_fec, n_ti, l1_cells)   # one plan
    return ChainPlan(mode, plp, n_fec, n_ti, l1_cells, sfn)


@contextlib.contextmanager
def _f32_products():
    """Hold float32 matmuls to float32: cuBLAS would round their inputs to
    TF32 (~1e-3 relative) when the process allows it.  Restores the
    caller's setting afterwards."""
    mm = torch.backends.cuda.matmul
    old = mm.allow_tf32
    mm.allow_tf32 = False
    try:
        yield
    finally:
        mm.allow_tf32 = old


def _grouped_interp(flat: torch.Tensor, groups, regroup: torch.Tensor,
                    K: int) -> torch.Tensor:
    """Banded-interpolation matmuls: per segment of 256 carriers, gather
    the pilot window straight from the flat carrier plane [F, L*K], fold in
    the reference (and, on Wiener rows, the delay-centring rotation), and
    multiply by the banded weight block.  Returns the [F, L, K] estimate."""
    outs = []
    with _f32_products():
        for win_idx, si, wband, rot in groups:
            h = flat[:, win_idx] * si                     # [F, Lg, S, Wg]
            er = torch.einsum("flsw,swc->flsc", h.real, wband)
            ei = torch.einsum("flsw,swc->flsc", h.imag, wband)
            f, lg = er.shape[:2]
            est = torch.complex(er.reshape(f, lg, -1)[..., :K],
                                ei.reshape(f, lg, -1)[..., :K])
            if rot is not None:                 # undo the delay centring
                est = est * rot
            outs.append(est)
    return torch.cat(outs, dim=1)[:, regroup]


def _abs2(x: torch.Tensor) -> torch.Tensor:
    return x.real ** 2 + x.imag ** 2


def equalize_plane(carriers: torch.Tensor, plan: ChainPlan, consts: dict):
    """[F, L, K] complex carriers -> ([F, L, K] equalized plane, diag).

    diag: ``phase_offset`` and ``sro`` [F, L] (the tracking
    discriminators); on SFN plans also ``csi`` [F, L, K] (mean-normalised
    |h|^2, for the demapper) and ``cir_p`` [F, n_delays] (the delay
    profile of each frame's mean channel, for the timing loop)."""
    f = carriers.shape[0]
    K = plan.mode.k_total
    if "ph_rot" in consts:
        # per-symbol common-phase derotation, measured differentially
        # against symbol 0 of the same frame on the ph_rot carriers:
        # z_l = sum_k a_l(k) conj(a_0(k)), a = carriers * ph_rot.  The
        # product weights each carrier by |h(k)|^2 >= 0, so a
        # frequency-selective channel cannot cancel it; symbol 0's own
        # phase stays, common to every row, and the estimate absorbs it
        a = carriers * consts["ph_rot"]
        z = torch.sum(a * a[:, :1].conj(), dim=-1, keepdim=True)  # [F, L, 1]
        inv_mag = torch.rsqrt(torch.clamp(_abs2(z), min=1e-18))
        carriers = carriers * (z.conj() * inv_mag)
    flat = carriers.reshape(f, -1)
    h_d = _grouped_interp(flat, consts["w"], consts["regroup"], K)

    if plan.mode.miso:
        # the second plane of the opposite pilot polarity separates the two
        # transmit groups' channels; then carrier-order payload pairs are
        # Alamouti-combined:
        # out[x] = (h1[x]* r[x] + s_x h2[y] r[y]*) / (|h1[x]|^2 + |h2[y]|^2)
        # with y the partner of x, taken by one gather over pair_idx
        h_alt = _grouped_interp(flat, consts["walt"], consts["regroup_alt"],
                                K)
        h1 = (h_d + h_alt) * 0.5
        h2 = (h_d - h_alt) * 0.5 * consts["o_sign"]
        pair = consts["pair_idx"]
        r_p = torch.index_select(flat, 1, pair).reshape(carriers.shape)
        h2_p = torch.index_select(h2.reshape(f, -1), 1, pair).reshape(
            carriers.shape)
        num = h1.conj() * carriers + (h2_p * r_p.conj()) * consts["pair_sign"]
        eq = num / torch.clamp(_abs2(h1) + _abs2(h2_p), min=1e-9)
    else:
        eq = carriers * h_d.conj() / torch.clamp(_abs2(h_d), min=1e-9)

    # ---- diagnostics (the reference's tracking discriminators) ----
    # common phase offset: sum of pilot phasors per half-spectrum, as a
    # dense +-1-masked row reduction
    sum1 = torch.sum(carriers * consts["ph_mask1"], dim=-1)
    sum2 = torch.sum(carriers * consts["ph_mask2"], dim=-1)
    phase_offset = torch.angle(sum1) + torch.angle(sum2)

    # sampling-rate offset: per-pilot symbol-pair phasor z = p_l conj(p_l-1),
    # derotated by the common rotation (the summed phasor) before the
    # half-spectrum difference so residual CFO cannot leak into it
    sro_pil = carriers[..., consts["sro_idx"]] * consts["sro_ref"]
    z = sro_pil[:, 1:] * sro_pil[:, :-1].conj()
    zs = torch.sum(z, dim=-1, keepdim=True)
    mag = torch.sqrt(torch.clamp(zs.real ** 2 + zs.imag ** 2, min=1e-18))
    drift = (z.imag * zs.real - z.real * zs.imag) / mag
    fh = consts["sro_first_half"]
    d1 = torch.sum(torch.where(fh, drift, 0.0), dim=-1)
    d2 = torch.sum(torch.where(fh, 0.0, drift), dim=-1)
    pwr = torch.mean(sro_pil.real ** 2 + sro_pil.imag ** 2, dim=-1)
    sro = torch.cat([torch.zeros_like(pwr[:, :1]),
                     (d2 - d1) / torch.clamp(pwr[:, 1:] * sro_pil.shape[-1],
                                             min=1e-9)], dim=1)
    diag = dict(phase_offset=phase_offset, sro=sro)
    if "cir_tab" in consts:
        # per-carrier channel power, mean-normalised per frame: an SFN
        # echo carves nulls where the equalized cells are amplified noise,
        # and the demapper weights each cell's LLRs by it
        ab2 = _abs2(h_d)
        diag["csi"] = ab2 / torch.clamp(ab2.mean(dim=(1, 2), keepdim=True),
                                        min=1e-12)
        # delay profile |cir(d)|^2 of each frame's mean channel estimate
        # (its rows are phase-aligned by the derotation above)
        tr, ti = consts["cir_tab"]                          # [K, nd]
        hm = h_d.mean(dim=1)                                # [F, K]
        hr, hi = hm.real.contiguous(), hm.imag.contiguous()
        with _f32_products():
            diag["cir_p"] = ((hr @ tr - hi @ ti) ** 2
                             + (hr @ ti + hi @ tr) ** 2)
    return eq, diag


def frames_to_eq(frames_iq: torch.Tensor, plan: ChainPlan, consts: dict):
    """[F, frame_samples] complex64 -> (eq planes [F, L, K], diag).

    The PLP-independent half (demod + pilot equalization): a multi-PLP
    receiver runs it once per batch and feeds every PLP's demap from it.
    """
    carriers, gi_cfo = ofdm.demod_frame(frames_iq, plan.mode)
    eq, diag = equalize_plane(carriers, plan, consts)
    diag["gi_cfo"] = gi_cfo
    return eq, diag


def _cells(plane: torch.Tensor, cell_idx: torch.Tensor) -> torch.Tensor:
    """[F, L, K] plane -> [F*n_fec, n_cells] by the composed gather."""
    cells = plane.reshape(plane.shape[0], -1)[:, cell_idx.reshape(-1)]
    return cells.reshape(-1, cell_idx.shape[1])


def eq_to_cells(eq: torch.Tensor, consts: dict) -> torch.Tensor:
    """Eq planes [F, L, K] -> the PLP's deinterleaved cells
    [F*n_fec, n_cells], by the composed gather."""
    return _cells(eq, consts["cell_idx"])


def packed_to_llr(eq: torch.Tensor, plan: ChainPlan, consts: dict,
                  csi: torch.Tensor | None = None):
    """Eq planes [F, L, K] -> (llr [F*n_fec, N] int8, snr_db [F]).

    Counterpart of the JAX ``packed_to_llr_t``, with codewords as rows:
    the LDPC kernel gives each codeword its own thread block, which then
    reads its channel LLRs as one contiguous row (the JAX layout puts
    codewords on the TPU's lanes instead).  Rows are in LDPC-kernel bit
    order (ops/ldpc.kernel_bit_order).  ``csi`` ([F, L, K], from an SFN
    plan's diag) goes through the same cell gather and weights each cell's
    LLRs by its channel power.
    """
    f = eq.shape[0]
    cells = eq_to_cells(eq, consts)                     # [F*n_fec, n_cells]
    csi_cells = None if csi is None else _cells(csi, consts["cell_idx"])
    planes, snr = llr_mod.demap_cells_planes(cells, f, plan.demap,
                                             csi=csi_cells)
    if plan.bit_blocks is not None:
        # each kernel-row block is one bit plane sliced at stride `step`
        # and cyclically rolled: no N-element gather
        segs = []
        for b, phase, step, roll, _ln in plan.bit_blocks:
            v = planes[b][:, phase::step] if step > 1 else planes[b]
            segs.append(v if roll == 0 else
                        torch.cat([v[:, roll:], v[:, :roll]], dim=1))
        llr = torch.cat(segs, dim=1)
    else:
        stream = torch.stack(planes, dim=-1).reshape(cells.shape[0], -1)
        llr = stream[:, consts["bit_rows"]]
    return llr.contiguous(), snr


def frames_to_llr(frames_iq: torch.Tensor, plan: ChainPlan, consts: dict):
    """[F, frame_samples] -> (llr [F*n_fec, N] int8, diag)."""
    eq, diag = frames_to_eq(frames_iq, plan, consts)
    llr, snr = packed_to_llr(eq, plan, consts, csi=diag.pop("csi", None))
    diag["snr_db"] = snr
    return llr, diag
