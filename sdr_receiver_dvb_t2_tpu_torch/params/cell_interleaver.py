"""Cell interleaver permutations (ETSI EN 302 755 clause 6.4).

The cell interleaver applies a pseudo-random permutation to the cells of each
FEC block, with a per-FEC-block bit-reversed shift so consecutive blocks use
different rotations of the same base sequence.

Forward (transmit) semantics produced here:
    ``out[(S[w] + shift[r]) % n_cells] = in[w]``  for FEC block r.

The base sequence S and the shift schedule follow the spec's LFSR
construction; the reference receiver builds the same permutation at
reference/src/DVB_T2/time_deinterleaver.cpp:155-246.
"""
from __future__ import annotations

import functools
import numpy as np

_TAPS = {
    11: (0, 3),
    12: (0, 2),
    13: (0, 1, 4, 6),
    14: (0, 1, 4, 5, 9, 11),
    15: (0, 1, 2, 12),
}


@functools.lru_cache(maxsize=None)
def base_sequence(n_cells: int) -> np.ndarray:
    """Base permutation S (length n_cells) for a FEC block of n_cells cells."""
    pn_degree = int(np.ceil(np.log2(n_cells)))
    max_states = 1 << pn_degree
    taps = _TAPS[pn_degree]
    mask = (1 << (pn_degree - 1)) - 1
    lfsr = 0
    out = np.empty(n_cells, dtype=np.int64)
    q = 0
    for i in range(max_states):
        if i in (0, 1):
            lfsr = 0
        elif i == 2:
            lfsr = 1
        else:
            fb = 0
            for t in taps:
                fb ^= (lfsr >> t) & 1
            lfsr = ((lfsr & mask) >> 1) | (fb << (pn_degree - 2))
        val = lfsr | ((i % 2) << (pn_degree - 1))
        if val < n_cells:
            out[q] = val
            q += 1
    assert q == n_cells
    return out


@functools.lru_cache(maxsize=None)
def shifts(n_cells: int, n_blocks: int) -> np.ndarray:
    """Per-FEC-block shift values (bit-reversed counter, clause 6.4)."""
    pn_degree = int(np.ceil(np.log2(n_cells)))
    vals = np.empty(n_blocks, dtype=np.int64)
    n = 0
    for r in range(n_blocks):
        shift = n_cells
        while shift >= n_cells:
            temp = n
            shift = 0
            for _ in range(pn_degree):
                shift |= temp & 1
                shift <<= 1
                temp >>= 1
            n += 1
        vals[r] = shift
    return vals


@functools.lru_cache(maxsize=None)
def tx_permutations(n_cells: int, n_blocks: int) -> np.ndarray:
    """[n_blocks, n_cells] array P with out[P[r, w]] = in[w] per block."""
    s = base_sequence(n_cells)
    sh = shifts(n_cells, n_blocks)
    return (s[None, :] + sh[:, None]) % n_cells
