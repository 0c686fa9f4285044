"""Loader for the ETSI EN 302 755 constant tables bundled as .npz archives.

The archives are produced by ``tools/extract_etsi_tables.py`` (see that file
for provenance).  Everything here is pure NumPy and runs at trace/setup time;
nothing in this module touches the device.
"""
from __future__ import annotations

import functools
from pathlib import Path

import numpy as np

_DATA = Path(__file__).resolve().parent / "data"


@functools.lru_cache(maxsize=None)
def carriers() -> dict:
    """All carrier-index / pattern tables keyed by name (int64 arrays)."""
    with np.load(_DATA / "etsi_carriers.npz") as z:
        return {k: z[k].copy() for k in z.files}


class LdpcTable:
    """One LDPC code definition from EN 302 755 Annex A/B/C.

    Attributes mirror the standard's structure: codewords have N bits,
    K information bits, grouped in M=360-bit groups.  ``pos`` is a ragged
    list of accumulator base addresses per group (one row per bit group),
    derived from DEG/LEN/POS exactly like the table walker at
    reference/src/DVB_T2/LDPC/ldpc.hh:56-122 interprets them.
    """

    def __init__(self, name, M, N, K, links_total, links_max_cn, deg, length, pos):
        self.name = name
        self.M = int(M)
        self.N = int(N)
        self.K = int(K)
        self.R = self.N - self.K
        self.q = self.R // self.M
        self.links_total = int(links_total)
        self.links_max_cn = int(links_max_cn)
        groups = []
        idx = 0
        for d, l in zip(deg, length):
            if d == 0:
                break
            for _ in range(int(l)):
                groups.append(pos[idx:idx + int(d)].astype(np.int64))
                idx += int(d)
        assert idx == len(pos)
        assert len(groups) * self.M == self.K, (name, len(groups), self.K)
        self.groups = groups  # ragged: groups[g] = accumulator bases for group g

    def accumulator_addresses(self, g: int, m: int) -> np.ndarray:
        """Parity accumulator addresses of information bit g*360+m."""
        return (self.groups[g] + m * self.q) % self.R


# Non-ETSI codes registered at run time (synthetic test codes, custom QC-IRA
# codes).  Checked before the bundled archives; register before first lookup
# (ldpc_table results are cached).
_REGISTERED: dict[str, LdpcTable] = {}


def register_table(table: LdpcTable) -> None:
    """Register a custom QC-IRA code under ``table.name``."""
    _REGISTERED[table.name] = table


@functools.lru_cache(maxsize=None)
def ldpc_table(name: str) -> LdpcTable:
    """Load one code table, e.g. ``ldpc_table("NORMAL_C2_3")``."""
    if name in _REGISTERED:
        return _REGISTERED[name]
    with np.load(_DATA / "etsi_ldpc.npz") as z:
        return LdpcTable(
            name,
            M=z[f"{name}__M"], N=z[f"{name}__N"], K=z[f"{name}__K"],
            links_total=z[f"{name}__LINKS_TOTAL"],
            links_max_cn=z[f"{name}__LINKS_MAX_CN"],
            deg=z[f"{name}__DEG"], length=z[f"{name}__LEN"], pos=z[f"{name}__POS"],
        )


def ldpc_table_names() -> list[str]:
    with np.load(_DATA / "etsi_ldpc.npz") as z:
        return sorted({k.split("__")[0] for k in z.files})
