"""Static edge tables of the DVB-T2 quasi-cyclic IRA codes, and the batched
flooding offset-min-sum decoder that the L1 soft path runs (plain PyTorch).

Permuting parity space by the standard's own parity interleaver turns every
Tanner edge into a cyclic shift within a 360-wide block (params/ldpc.py),
so a decoder only needs, per check row, the list of (variable group,
shift) pairs.  The layered decoder in ops/ldpc.py builds its per-row slot
tables from this plan.

The flooding decoder (:func:`make_decoder`) holds its messages as
[B, q, CNL+2, 360]: data-edge slots, the parity self slot and the
staircase-neighbour slot.  Message algebra is offset-min-sum with beta = 1
(reference LDPC/algorithms.hh:250-291): magnitudes saturate at 0 after the
offset, the second-minimum trick picks the extrinsic min, stored messages
clamp to [-32, 31].  float32 compute, exact for integer-valued LLRs.  Each
static roll of a 360-lane block is folded into one gather index, so the
variable-to-check alignment is a single gather and the check-to-variable
sums a single ``index_add_``.

LLR convention: positive LLR = bit 0 (matches the reference demapper).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..params import ldpc

_BIG = 1e9
M = 360


class QCPlan:
    """Static edge lists of one code, grouped for the roll-based decoder.

    edges_by_row[i]  = list of (group g, shift s, var-slot d) for check row i
    edges_by_group[g] = list of (row i, slot c, shift s) for bit group g
    """

    def __init__(self, table_name: str):
        code = ldpc.get_code(table_name)
        t = code.table
        self.name = table_name
        self.n, self.k, self.r, self.q = code.n, code.k, code.r, code.q
        self.g_data = self.k // M
        self.cnl = t.links_max_cn - 2
        rows = [[] for _ in range(self.q)]
        groups = [[] for _ in range(self.g_data)]
        for g, bases in enumerate(t.groups):
            for p in bases:
                i, s = int(p % self.q), int(p // self.q)
                slot = len(rows[i])
                rows[i].append((g, s, len(groups[g])))
                groups[g].append((i, slot, s))
        assert max(len(x) for x in rows) <= self.cnl
        self.edges_by_row = rows
        self.edges_by_group = groups


@functools.lru_cache(maxsize=None)
def get_plan(table_name: str) -> QCPlan:
    return QCPlan(table_name)


def _check_update(stacked, mask, c2v, beta: float):
    """stacked, c2v: [B, q, C, 360]; returns new c2v."""
    v2c = stacked - c2v
    mag = torch.clamp(torch.abs(v2c) - beta, min=0.0)
    mag = torch.where(mask, mag, _BIG)
    neg = mask & (v2c < 0)
    m1 = torch.amin(mag, dim=2, keepdim=True)
    is_min = mag == m1
    first_min = torch.cumsum(is_min.to(torch.int32), dim=2) == 1
    only_first = is_min & first_min
    m2 = torch.amin(torch.where(only_first, _BIG, mag), dim=2, keepdim=True)
    total = (neg.to(torch.int32).sum(2, keepdim=True) % 2).bool()
    out_neg = total ^ neg
    out_mag = torch.where(only_first, m2, m1)
    out = torch.where(out_neg, -out_mag, out_mag)
    return torch.clamp(torch.where(mask, out, 0.0), -32.0, 31.0)


class _Tables:
    """The decoder's static tensors on one device."""

    def __init__(self, plan: QCPlan, device):
        q, cnl = plan.q, plan.cnl
        # flat data-posterior index of each (row, slot, lane); roll(v, s)
        # at lane j reads lane (j - s) % 360.  Empty slots read column
        # k, an appended constant _BIG.
        lane = np.arange(M)
        idx = np.full((q, cnl, M), plan.k, np.int64)
        for i, es in enumerate(plan.edges_by_row):
            for c, (g, s, _d) in enumerate(es):
                idx[i, c] = g * M + (lane - s) % M
        mask = np.zeros((q, cnl + 2), bool)
        for i, es in enumerate(plan.edges_by_row):
            mask[i, :len(es)] = True
        mask[:, cnl:] = True
        mask = np.broadcast_to(mask[None, :, :, None],
                               (1, q, cnl + 2, M)).copy()
        # the prev-parity slot of natural check 0 (row 0, lane 0) is empty
        mask[0, 0, cnl + 1, 0] = False
        data = idx.reshape(-1) < plan.k
        self.gather = torch.from_numpy(idx.reshape(-1)).to(device)
        self.scatter = torch.from_numpy(idx.reshape(-1)[data]).to(device)
        self.data = torch.from_numpy(data).to(device)
        self.mask = torch.from_numpy(mask).to(device)


def make_decoder(table_name: str, max_iters: int = 15, beta: float = 1.0):
    """Returns decode(llr [B, N] tensor) -> (hard_bits [B, N] int8,
    ok [B] bool, iters [B] int32 per-codeword first-clean iteration), run
    on the device of ``llr``.  The sweep loop leaves as soon as every
    codeword is clean."""
    plan = get_plan(table_name)
    k, r, q, cnl = plan.k, plan.r, plan.q, plan.cnl
    tables: dict = {}

    def align(lam_data, lam_par, t):
        """lam_data [B, k], lam_par [B, r] -> checks [B, q, C, 360]."""
        b = lam_data.shape[0]
        padded = torch.cat([lam_data, torch.full((b, 1), _BIG,
                                                 device=lam_data.device)], 1)
        data_part = padded[:, t.gather].reshape(b, q, cnl, M)
        p_perm = lam_par.reshape(b, M, q).transpose(1, 2)
        prev_flat = torch.cat([torch.full((b, 1), _BIG,
                                          device=lam_par.device),
                               lam_par[:, :-1]], dim=1)
        p_prev = prev_flat.reshape(b, M, q).transpose(1, 2)
        return torch.cat([data_part, p_perm[:, :, None, :],
                          p_prev[:, :, None, :]], dim=2)

    def back(c2v, ch_data, ch_par, t):
        """c2v [B, q, C, 360] -> lam_data [B, k], lam_par [B, r]."""
        b = c2v.shape[0]
        msgs = c2v[:, :, :cnl, :].reshape(b, -1)[:, t.data]
        lam_data = ch_data.clone().index_add_(1, t.scatter, msgs)
        self_nat = c2v[:, :, cnl, :].transpose(1, 2).reshape(b, r)
        prev_nat = c2v[:, :, cnl + 1, :].transpose(1, 2).reshape(b, r)
        nxt = torch.cat([prev_nat[:, 1:], torch.zeros_like(prev_nat[:, :1])],
                        dim=1)
        return lam_data, ch_par + self_nat + nxt

    def syndrome_ok(stacked, t):
        """[B, q, C, 360] aligned LLRs -> [B] all-checks-satisfied."""
        neg = t.mask & (stacked < 0)
        odd = (neg.to(torch.int32).sum(2) % 2).bool()       # [B, q, 360]
        return ~odd.reshape(odd.shape[0], -1).any(dim=1)

    def decode(llr: torch.Tensor):
        t = tables.get(llr.device)
        if t is None:
            t = tables[llr.device] = _Tables(plan, llr.device)
        # clamp the channel intrinsics below the weakest bit's total
        # extrinsic correction capacity (degree-2 staircase parity: 2*31):
        # a saturated WRONG bit would otherwise be permanently stuck.  Same
        # clamp as the layered decoder.
        llr = torch.clamp(llr.to(torch.float32), -56.0, 56.0)
        b = llr.shape[0]
        ch_data, ch_par = llr[:, :k].contiguous(), llr[:, k:].contiguous()
        c2v = torch.zeros((b, q, cnl + 2, M), dtype=torch.float32,
                          device=llr.device)
        lam_data, lam_par = ch_data, ch_par
        stacked = align(lam_data, lam_par, t)
        okv = syndrome_ok(stacked, t)
        first = torch.where(okv, 0, -1).to(torch.int32)
        it = 0
        while it < max_iters and not bool(okv.all()):
            c2v = _check_update(stacked, t.mask, c2v, beta)
            lam_data, lam_par = back(c2v, ch_data, ch_par, t)
            stacked = align(lam_data, lam_par, t)
            okv = syndrome_ok(stacked, t)
            first = torch.where((first < 0) & okv, it + 1, first)
            it += 1
        iters = torch.where(okv, torch.clamp(first, min=0), max_iters)
        hard = torch.cat([lam_data < 0, lam_par < 0], dim=1)
        return hard.to(torch.int8), okv, iters.to(torch.int32)

    return decode
