"""Quasi-cyclic LDPC code structure, encoder, and decoder index plans.

DVB-T2 LDPC codes (ETSI EN 302 755 clause 6.1.2, tables in annex A/B) are
IRA codes: information bits are accumulated into R parity accumulators via
per-360-bit-group base addresses, then a staircase p_r ^= p_{r-1} finishes
encoding.  Information bit i = 360*g + m accumulates into addresses
``(base[g][k] + m*q) mod R``.

Key structural fact used by the decoder: permuting parity space by the
standard's own parity interleaver (r = q*s + t  <->  (t, s)) turns every
group-edge into a *cyclic shift within a 360-wide block*:

    check (t=p%q, s=(p//q + m) mod 360)  connects  variable (g, m)

so all check-side gathers are 360-lane rolls — regular memory access that
maps well onto vector lanes.  (The reference exploits the same structure
serially at reference/src/DVB_T2/LDPC/ldpc.hh:102-113.)

This module is pure NumPy; the device decoder lives in ops/ldpc.py.
"""
from __future__ import annotations

import dataclasses
import functools
import numpy as np

from . import tables


@dataclasses.dataclass(frozen=True)
class CheckPlan:
    """Static gather/scatter plans for a batched flooding decoder.

    All arrays are int32.  B = codeword batch, N/K/R/q as usual,
    CNL = max data (information) edges per check, DEG = max edges per
    information variable.

    var_of_check  [R, CNL]  flat info-bit index feeding check r at slot c,
                            or -1 padding.
    check_of_var  [K, DEG]  flat (r * CNL + slot) index of the check-side
                            message slot consuming info bit v, or -1.
    deg_var       [K]       true degree of each info bit.
    cnt_check     [R]       true number of info edges per check.
    """
    n: int
    k: int
    q: int
    cnl: int
    deg_max: int
    var_of_check: np.ndarray
    check_of_var: np.ndarray
    deg_var: np.ndarray
    cnt_check: np.ndarray


class LdpcCode:
    def __init__(self, table_name: str):
        self.table = t = tables.ldpc_table(table_name)
        self.name = table_name
        self.n, self.k, self.r, self.q = t.N, t.K, t.R, t.q
        self.m = t.M

    # -- encoder ------------------------------------------------------------
    @functools.cached_property
    def _acc_links(self) -> tuple[np.ndarray, np.ndarray]:
        """(bit_index, acc_address) per link, both [links_total]."""
        t, q, r = self.table, self.q, self.r
        bits, accs = [], []
        for g, bases in enumerate(t.groups):
            m = np.arange(360)
            addr = (bases[None, :] + m[:, None] * q) % r     # [360, deg]
            bit = g * 360 + m
            bits.append(np.repeat(bit, len(bases)))
            accs.append(addr.reshape(-1))
        return np.concatenate(bits).astype(np.int64), np.concatenate(accs).astype(np.int64)

    def encode(self, info_bits: np.ndarray) -> np.ndarray:
        """Encode [..., K] uint8 bits -> [..., N] codewords (numpy)."""
        info_bits = np.asarray(info_bits, dtype=np.uint8)
        batch_shape = info_bits.shape[:-1]
        flat = info_bits.reshape(-1, self.k)
        bit_idx, acc_idx = self._acc_links
        out = np.empty((flat.shape[0], self.n), dtype=np.uint8)
        for b in range(flat.shape[0]):
            p = np.zeros(self.r, dtype=np.uint8)
            np.bitwise_xor.at(p, acc_idx, flat[b, bit_idx])
            p = np.bitwise_xor.accumulate(p)                  # staircase
            out[b, :self.k] = flat[b]
            out[b, self.k:] = p
        return out.reshape(*batch_shape, self.n)

    def check(self, codeword: np.ndarray) -> bool:
        """True iff all parity checks are satisfied (numpy reference)."""
        cw = np.asarray(codeword, dtype=np.uint8)
        bit_idx, acc_idx = self._acc_links
        syn = np.zeros(self.r, dtype=np.uint8)
        np.bitwise_xor.at(syn, acc_idx, cw[bit_idx])
        p = cw[self.k:]
        syn ^= p
        syn[1:] ^= p[:-1]
        return not syn.any()

    # -- decoder plan --------------------------------------------------------
    @functools.cached_property
    def plan(self) -> CheckPlan:
        t, q, r, k = self.table, self.q, self.r, self.k
        cnl = t.links_max_cn - 2          # staircase contributes the other 2
        # edges: (group g, base p) -> row i = p%q, shift s = p//q
        rows, shifts, groups = [], [], []
        for g, bases in enumerate(t.groups):
            for p in bases:
                rows.append(p % q)
                shifts.append(p // q)
                groups.append(g)
        rows = np.array(rows)
        shifts = np.array(shifts)
        groups = np.array(groups)

        var_of_check = np.full((r, cnl), -1, dtype=np.int64)
        slot_of_edge = np.empty(len(rows), dtype=np.int64)
        next_slot = np.zeros(q, dtype=np.int64)
        for e, i in enumerate(rows):
            slot_of_edge[e] = next_slot[i]
            next_slot[i] += 1
        assert next_slot.max() <= cnl
        j = np.arange(360)
        for e, (g, i, s) in enumerate(zip(groups, rows, shifts)):
            checks = q * j + i                               # all 360 checks
            variables = g * 360 + ((j - s) % 360)
            var_of_check[checks, slot_of_edge[e]] = variables

        deg_max = max(len(b) for b in self.table.groups)
        check_of_var = np.full((k, deg_max), -1, dtype=np.int64)
        fill = np.zeros(k, dtype=np.int64)
        for e, (g, i, s) in enumerate(zip(groups, rows, shifts)):
            variables = g * 360 + j
            checks = q * ((j + s) % 360) + i
            check_of_var[variables, fill[variables]] = checks * cnl + slot_of_edge[e]
            fill[variables] += 1

        deg_var = fill
        cnt_check = next_slot[np.arange(r) % q]
        return CheckPlan(
            n=self.n, k=k, q=q, cnl=cnl, deg_max=deg_max,
            var_of_check=var_of_check.astype(np.int32),
            check_of_var=check_of_var.astype(np.int32),
            deg_var=deg_var.astype(np.int32),
            cnt_check=cnt_check.astype(np.int32),
        )


@functools.lru_cache(maxsize=None)
def get_code(table_name: str) -> LdpcCode:
    return LdpcCode(table_name)
