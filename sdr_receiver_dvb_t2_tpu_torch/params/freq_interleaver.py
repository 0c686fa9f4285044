"""Frequency interleaver address generation (ETSI EN 302 755 clause 8.5).

Generates the per-FFT-size pseudo-random address sequences H_even/H_odd used
to interleave data cells onto OFDM carriers, using the spec's LFSR + bit
permutation construction (feedback taps per table 50-55; permutation tables
from the extracted ETSI constants).

Conventions (matching the reference receiver's observed behaviour at
reference/src/DVB_T2/address_freq_deinterleaver.cpp:136-209 and
p2_symbol.cpp:108-109):

* ``tx_permutation(mode, n_cells, parity)`` returns H with semantics
  ``interleaved[H[q]] = cells[q]``;
* frame symbol index l uses the *odd* table when l is even and vice versa;
* for 32K the even table is the inverse permutation of the odd table.

Deinterleaving in the receiver is then the gather ``cells = interleaved[H]``.
"""
from __future__ import annotations

import functools
import numpy as np

from . import tables
from .modes import T2Mode

# LFSR feedback tap positions per FFT size (EN 302 755 clause 8.5)
_TAPS = {
    1024: (0, 4),
    2048: (0, 3),
    4096: (0, 2),
    8192: (0, 1, 4, 6),
    16384: (0, 1, 4, 5, 9, 11),
    32768: (0, 1, 2, 12),
}
_PERM_KEY = {
    1024: ("bitperm1keven", "bitperm1kodd"),
    2048: ("bitperm2keven", "bitperm2kodd"),
    4096: ("bitperm4keven", "bitperm4kodd"),
    8192: ("bitperm8keven", "bitperm8kodd"),
    16384: ("bitperm16keven", "bitperm16kodd"),
    32768: ("bitperm32k", "bitperm32k"),
}


@functools.lru_cache(maxsize=None)
def _candidate_addresses(fft_size: int) -> tuple[np.ndarray, np.ndarray]:
    """All Mmax candidate addresses (even-table, odd-table) for one FFT size."""
    nbits = fft_size.bit_length() - 1          # log2
    pn_degree = nbits - 1
    mmax = fft_size
    taps = _TAPS[fft_size]
    perm_even, perm_odd = (tables.carriers()[k] for k in _PERM_KEY[fft_size])
    mask = (1 << pn_degree) - 1
    lfsr = 0
    even = np.empty(mmax, dtype=np.int64)
    odd = np.empty(mmax, dtype=np.int64)
    for i in range(mmax):
        if i in (0, 1):
            lfsr = 0
        elif i == 2:
            lfsr = 1
        else:
            fb = 0
            for t in taps:
                fb ^= (lfsr >> t) & 1
            lfsr = ((lfsr & mask) >> 1) | (fb << (pn_degree - 1))
        e = o = 0
        for n in range(pn_degree):
            bit = (lfsr >> n) & 1
            e |= bit << perm_even[n]
            o |= bit << perm_odd[n]
        toggle = (i % 2) * (mmax // 2)
        even[i] = e + toggle
        odd[i] = o + toggle
    return even, odd


@functools.lru_cache(maxsize=None)
def tx_permutations(fft_size: int, n_cells: int) -> tuple[np.ndarray, np.ndarray]:
    """(H_even, H_odd) arrays of length n_cells for a symbol of n_cells."""
    cand_even, cand_odd = _candidate_addresses(fft_size)
    h_even = cand_even[cand_even < n_cells]
    h_odd = cand_odd[cand_odd < n_cells]
    assert len(h_even) == n_cells and len(h_odd) == n_cells, \
        (fft_size, n_cells, len(h_even), len(h_odd))
    if fft_size == 32768:
        inv = np.empty_like(h_odd)
        inv[h_odd] = np.arange(n_cells)
        h_even = inv
    return h_even, h_odd


def tx_permutation(mode: T2Mode, n_cells: int, symbol_index: int) -> np.ndarray:
    """H for frame symbol ``symbol_index``: interleaved[H[q]] = cells[q]."""
    h_even, h_odd = tx_permutations(mode.fft_size, n_cells)
    return h_odd if symbol_index % 2 == 0 else h_even
