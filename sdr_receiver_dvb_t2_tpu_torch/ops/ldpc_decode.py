"""Static edge tables of the DVB-T2 quasi-cyclic IRA codes (host numpy).

Permuting parity space by the standard's own parity interleaver turns every
Tanner edge into a cyclic shift within a 360-wide block (params/ldpc.py),
so a decoder only needs, per check row, the list of (variable group,
shift) pairs.  The layered decoder in ops/ldpc.py builds its per-row slot
tables from this plan.
"""
from __future__ import annotations

import functools

from ..params import ldpc

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
