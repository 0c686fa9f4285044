"""Fused frame-batch receive chain: OFDM demod -> equalize -> demap -> LLR.

Two structural choices carry over from the JAX chain:

1. **Channel interpolation as a banded matmul.**  Linear interpolation
   between pilots is a linear operator; for each distinct pilot layout the
   pilot->carrier weights are stored banded per 256-carrier segment
   ([n_seg, WIN, SEG]) and the per-symbol channel estimate is one pilot
   window gather plus one batched matmul per layout group.
2. **One composed gather.**  Frequency deinterleave, the L1/PLP slice and
   the time+cell deinterleave are all static permutations; their
   composition maps each FEC-block cell straight to a carrier of the
   equalized [L, K] plane.

Precision: the port keeps complex64 end to end.  The JAX chain rounds the
carrier plane and the equalized plane to bf16 (its u32 packing); the port
does not, so its cells differ from the JAX ones by that rounding (about
2^-9 relative), which moves an int8 LLR by at most one step.

Only the SISO linear-interpolation branch is here; the SFN (Wiener rows,
``ph_rot``, CSI/CIR) and MISO branches are later work.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..params import freq_interleaver, pilots
from ..params.modes import T2Mode, PlpConfig
from . import equalizer as eq_mod
from . import llr as llr_mod
from . import ofdm
from .ldpc import kernel_bit_order


def _banded_interp_weights(K: int, seg: int, sets: list):
    """Banded linear-interpolation weight tables for per-symbol pilot sets.

    ``sets``: one dict per output symbol row l with keys
      src  — frame symbol whose carrier plane holds the pilots,
      pidx — sorted pilot carrier indices (int64),
      sign — TX1 reference sign per pilot,
      amp  — reference amplitude per pilot.
    Returns (group_syms, regroup, weights) with one weights entry
    (win_idx [Lg, S, Wg] int32, si_re [Lg, S, Wg], wband [S, Wg, SEG]) per
    group of rows sharing a pilot layout.

    Carrier k interpolates between pilot ordinals lo(k) and lo(k)+1, and lo
    is monotone in k, so a segment of SEG consecutive carriers touches only
    a narrow window of pilot ordinals.  win_idx[s, w] holds the flat
    carrier index of pilot ordinal o(s)+w, so pilot extraction and the
    per-segment window gather are one index table; the reference sign and
    amplitude normalization fold into si_re, with padded slots zeroed.
    """
    L = len(sets)
    n_seg = -(-K // seg)
    groups: dict[bytes, list[int]] = {}
    for l in range(L):
        groups.setdefault(sets[l]["pidx"].tobytes(), []).append(l)
    group_syms = [np.array(v, np.int32) for v in groups.values()]
    order = np.concatenate(group_syms)
    regroup = np.empty(L, np.int64)
    regroup[order] = np.arange(L)                   # undo group concat order

    weights = []
    for syms in group_syms:
        pidx = sets[int(syms[0])]["pidx"]
        n_pil = len(pidx)
        k = np.arange(K)
        lo = np.clip(np.searchsorted(pidx, k) - 1, 0, n_pil - 2)
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
        ords = np.minimum(o_idx[:, None] + np.arange(win)[None], n_pil - 1)
        valid = (o_idx[:, None] + np.arange(win)[None]) < n_pil
        flat = np.stack([np.broadcast_to(sets[int(l)]["src"],
                                         pidx.shape).astype(np.int64) * K
                         + pidx for l in syms])             # [Lg, n_pil]
        win_idx = flat[:, ords].astype(np.int32)            # [Lg, S, Wg]
        sign = np.stack([sets[int(l)]["sign"][ords] for l in syms])
        inv_amp = np.stack([1.0 / sets[int(l)]["amp"][ords] for l in syms])
        si_re = (sign * inv_amp * valid[None]).astype(np.float32)
        weights.append((win_idx, si_re, wband))
    return group_syms, regroup, weights


class EqTables:
    """Mode-only SISO equalizer tables (shared by every PLP of a mux)."""

    def __init__(self, mode: T2Mode):
        if mode.miso or eq_mod.sfn_reach_gated(mode):
            raise NotImplementedError(
                "only SISO modes with linear pilot interpolation are ported")
        self.mode = mode
        L, K = mode.frame_symbols, mode.k_total
        self.eq_plan = eq_mod.get_plan(mode)
        ep = self.eq_plan
        self.seg = 256

        sets = []
        for l in range(L):
            n = int(ep.n_pilots[l])
            sets.append(dict(src=l,
                             pidx=np.asarray(ep.pilot_idx[l][:n]).astype(np.int64),
                             sign=np.asarray(ep.ref_vals[l][:n]),
                             amp=np.asarray(ep.amp_vals[l][:n])))
        self.group_syms, self.regroup, self.weights = \
            _banded_interp_weights(K, self.seg, sets)

        # dense +-1 sign masks for the common-phase-offset discriminator
        # (sum of pilot phasors per half-spectrum)
        ph1 = np.zeros((L, K), np.float32)
        ph2 = np.zeros((L, K), np.float32)
        half = K // 2
        for l in range(L):
            n_pil = int(ep.n_pilots[l])
            pidx = np.asarray(ep.pilot_idx[l][:n_pil])
            sign = np.asarray(ep.ref_vals[l][:n_pil])
            fh = pidx < half
            ph1[l, pidx[fh]] = sign[fh]
            ph2[l, pidx[~fh]] = sign[~fh]
        self.ph_mask = (ph1, ph2)


@functools.lru_cache(maxsize=8)
def get_eq_tables(mode: T2Mode) -> EqTables:
    return EqTables(mode)


class ChainPlan:
    """All tables for frames -> LLR, one T2Mode + PLP config (host numpy).

    ``to_device`` moves them to a device once; the receiver keeps that
    copy for its lifetime.
    """

    def __init__(self, mode: T2Mode, plp: PlpConfig, n_fec: int, n_ti: int,
                 l1_cells: int):
        self.mode = mode
        self.plp = plp
        self.n_fec = n_fec
        self.l1_cells = l1_cells
        L, K = mode.frame_symbols, mode.k_total
        self.eq = get_eq_tables(mode)
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
        models.receiver.plan_from_numpy takes)."""
        out = dict(cell_idx=self.cell_idx, bit_rows=self.bit_rows,
                   sig_idx=self.sig_idx,
                   ph_mask1=self.eq.ph_mask[0], ph_mask2=self.eq.ph_mask[1],
                   regroup=self.eq.regroup,
                   sro_idx=np.asarray(self.eq_plan.sro_idx),
                   sro_ref=np.asarray(self.eq_plan.sro_ref),
                   sro_first_half=np.asarray(self.eq_plan.sro_first_half))
        for j, (wi, si, wb) in enumerate(self.eq.weights):
            out[f"w{j}_win_idx"] = wi
            out[f"w{j}_si_re"] = si
            out[f"w{j}_wband"] = wb
        return out

    def to_device(self, device) -> dict:
        """The device copy of the plan, built from :meth:`arrays`."""
        return consts_from_arrays(self.arrays(), device)


def consts_from_arrays(arrays: dict, device) -> dict:
    """Numpy plan arrays -> device tensors (index tables as int64)."""
    def t(a):
        a = np.asarray(a)
        if a.dtype.kind in "iu":
            a = a.astype(np.int64)
        return torch.as_tensor(a, device=device)

    n_groups = sum(1 for k in arrays if k.endswith("_win_idx"))
    consts = {k: t(v) for k, v in arrays.items() if not k.startswith("w")}
    consts["w"] = [(t(arrays[f"w{j}_win_idx"]), t(arrays[f"w{j}_si_re"]),
                    t(arrays[f"w{j}_wband"])) for j in range(n_groups)]
    return consts


@functools.lru_cache(maxsize=8)
def get_plan(mode: T2Mode, plp: PlpConfig, n_fec: int, n_ti: int,
             l1_cells: int) -> ChainPlan:
    return ChainPlan(mode, plp, n_fec, n_ti, l1_cells)


def _grouped_interp(flat: torch.Tensor, consts: dict, K: int) -> torch.Tensor:
    """Banded-interpolation matmuls: per segment of 256 carriers, gather
    the pilot window straight from the flat carrier plane [F, L*K] and
    multiply by the banded weight block.  Returns the [F, L, K] estimate."""
    outs = []
    for win_idx, si_re, wband in consts["w"]:
        h = flat[:, win_idx] * si_re                      # [F, Lg, S, Wg]
        er = torch.einsum("flsw,swc->flsc", h.real, wband)
        ei = torch.einsum("flsw,swc->flsc", h.imag, wband)
        f, lg = er.shape[:2]
        outs.append(torch.complex(er.reshape(f, lg, -1)[..., :K],
                                  ei.reshape(f, lg, -1)[..., :K]))
    return torch.cat(outs, dim=1)[:, consts["regroup"]]


def equalize_plane(carriers: torch.Tensor, plan: ChainPlan, consts: dict):
    """[F, L, K] complex carriers -> ([F, L, K] equalized plane, diag)."""
    f = carriers.shape[0]
    K = plan.mode.k_total
    h = _grouped_interp(carriers.reshape(f, -1), consts, K)
    denom = torch.clamp(h.real ** 2 + h.imag ** 2, min=1e-9)
    eq = carriers * h.conj() / denom

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
    return eq, dict(phase_offset=phase_offset, sro=sro)


def frames_to_eq(frames_iq: torch.Tensor, plan: ChainPlan, consts: dict):
    """[F, frame_samples] complex64 -> (eq planes [F, L, K], diag).

    The PLP-independent half (demod + pilot equalization): a multi-PLP
    receiver runs it once per batch and feeds every PLP's demap from it.
    """
    carriers, gi_cfo = ofdm.demod_frame(frames_iq, plan.mode)
    eq, diag = equalize_plane(carriers, plan, consts)
    diag["gi_cfo"] = gi_cfo
    return eq, diag


def eq_to_cells(eq: torch.Tensor, consts: dict) -> torch.Tensor:
    """Eq planes [F, L, K] -> the PLP's deinterleaved cells
    [F*n_fec, n_cells], by the composed gather."""
    cell_idx = consts["cell_idx"]
    cells = eq.reshape(eq.shape[0], -1)[:, cell_idx.reshape(-1)]
    return cells.reshape(-1, cell_idx.shape[1])


def packed_to_llr(eq: torch.Tensor, plan: ChainPlan, consts: dict):
    """Eq planes [F, L, K] -> (llr [F*n_fec, N] int8, snr_db [F]).

    Counterpart of the JAX ``packed_to_llr_t``, with codewords as rows:
    the LDPC kernel gives each codeword its own thread block, which then
    reads its channel LLRs as one contiguous row (the JAX layout puts
    codewords on the TPU's lanes instead).  Rows are in LDPC-kernel bit
    order (ops/ldpc.kernel_bit_order).
    """
    f = eq.shape[0]
    cells = eq_to_cells(eq, consts)                     # [F*n_fec, n_cells]
    planes, snr = llr_mod.demap_cells_planes(cells, f, plan.demap)
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
    llr, snr = packed_to_llr(eq, plan, consts)
    diag["snr_db"] = snr
    return llr, diag
