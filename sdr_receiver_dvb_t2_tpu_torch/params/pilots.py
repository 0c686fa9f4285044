"""Carrier maps and reference pilot sequences (ETSI EN 302 755 clause 9).

Produces, for a given :class:`~..params.modes.T2Mode`:

* integer carrier-type maps for P2 symbols, each data symbol position in the
  scattered-pilot cycle, and the frame-closing symbol;
* the real-valued reference pilot amplitude (+-boost) per symbol & carrier,
  i.e. exactly what the transmitter sends on every non-data carrier.

This mirrors the behaviour of the reference pilot generator
(reference/src/DVB_T2/pilot_generator.cpp) including its handling of
continual-pilot group moduli per FFT size and extended-carrier extras, but is
implemented as vectorized NumPy over precomputed index sets rather than
per-carrier switch statements.

MISO (clause 9.2.2.3 / 9.2.5): transmit group 2 negates a deterministic
subset of the pilots so a receiver can separate the two channels:

* P2 symbols: pilots on carriers ``k % 3 == 0`` with ``(k // 3)`` odd
  (pilot_generator.cpp:106-138); MISO P2 symbols also gain extra pilots
  next to the edge/PAPR holes so inversion pairs survive (:147-331).
* data symbols: every scattered pilot of a symbol shares one inversion
  state, ``(k // dx)`` odd — which alternates per symbol since the SP
  column shifts by dx each symbol (:481-486); edge pilots invert on odd
  symbol indices (:488-495); continual pilots that fall on SP-grid
  columns follow the SP rule, so their state is fixed per carrier (:482).
* FC symbol: the SP-grid rule per carrier; edge pilots follow the
  reference's ``(n_p2 + n_data - 1)`` parity (:2003-2013).

All cross-validated against the compiled reference generator for both TX
groups in tests/test_reference_oracle.py.
"""
from __future__ import annotations

import functools
import numpy as np

from . import tables
from .modes import T2Mode, PilotPattern, Papr

# carrier type codes
DATA = 0
P2 = 1
P2_PAPR = 2
SP = 3
CP = 4
TR_PAPR = 5
EDGE = 6  # edge pilots (treated like scattered pilots for amplitude)

_FFT_LABEL = {1024: "1k", 2048: "2k", 4096: "4k", 8192: "8k",
              16384: "16k", 32768: "32k"}

# continual-pilot group usage per FFT size: (group indices, modulus)
# groups are the CP1..CP6 sets of EN 302 755 annex H; positions are reduced
# modulo the per-FFT constant (pilot_generator.cpp:474-1890 applies the same
# reduction); 32K uses the raw values.
_CP_GROUPS = {
    1024: ((1,), 1632),
    2048: ((1, 2), 1632),
    4096: ((1, 2, 3), 3264),
    8192: ((1, 2, 3, 4), 6528),
    16384: ((1, 2, 3, 4, 5), 13056),
    32768: ((1, 2, 3, 4, 5, 6), None),
}


def _cp_positions(mode: T2Mode) -> np.ndarray:
    """Continual pilot carrier indices for this FFT size / pilot pattern."""
    t = tables.carriers()
    pp = mode.pilot_pattern.value + 1
    groups, modulus = _CP_GROUPS[mode.fft_size]
    pos = []
    for g in groups:
        key = f"pp{pp}_cp{g}"
        if key in t:
            v = t[key]
            pos.append(v % modulus if modulus else v)
    if mode.extended_carriers:
        extra_key = f"pp{pp}_{_FFT_LABEL[mode.fft_size]}"
        if extra_key in t:
            pos.append(t[extra_key])
    if not pos:
        return np.empty(0, dtype=np.int64)
    return np.unique(np.concatenate(pos))


def _tr_positions(mode: T2Mode, symbol_in_cycle: int) -> np.ndarray:
    """TR-PAPR reserved carriers for a data symbol (EN 302 755 clause 9.3.2)."""
    t = tables.carriers()
    base = t[f"tr_papr_map_{_FFT_LABEL[mode.fft_size]}"]
    if mode.extended_carriers:
        shift = mode.dx * ((symbol_in_cycle + mode.k_ext // mode.dx) % mode.dy)
    else:
        shift = mode.dx * (symbol_in_cycle % mode.dy)
    return base + shift


@functools.lru_cache(maxsize=None)
def p2_carrier_map(mode: T2Mode) -> np.ndarray:
    """Carrier-type map of a P2 symbol (EN 302 755 clause 9.2.3.1)."""
    k_total, k_ext = mode.k_total, mode.k_ext
    m = np.full(k_total, DATA, dtype=np.int8)
    step = 6 if (mode.fft_size == 32768 and not mode.miso) else 3
    m[::step] = P2
    if mode.extended_carriers and k_ext:
        m[:k_ext] = P2
        m[k_total - k_ext:] = P2
    papr = tables.carriers()[f"p2_papr_map_{_FFT_LABEL[mode.fft_size]}"]
    if mode.fft_size >= 8192:
        papr = papr + mode.k_ext
    if mode.miso:
        # extra P2 pilots so inversion pairs survive the band edges
        # (EN 302 755 clause 9.2.5; pilot_generator.cpp:141-146)
        m[[k_ext + 1, k_ext + 2,
           k_total - k_ext - 3, k_total - k_ext - 2]] = P2
    m[papr] = P2_PAPR
    if mode.miso:
        # ...and next to the PAPR holes (pilot_generator.cpp:147-331):
        # ki % 3 == 1 -> pilot at ki+1, ki % 3 == 2 -> pilot at ki-1,
        # unless that neighbour is itself a reserved hole
        holes = set(papr.tolist())
        for ki in papr:
            if ki % 3 == 1 and (ki + 1) not in holes:
                m[ki + 1] = P2
            if ki % 3 == 2 and (ki - 1) not in holes:
                m[ki - 1] = P2
    return m


@functools.lru_cache(maxsize=None)
def data_carrier_map(mode: T2Mode, symbol_in_cycle: int) -> np.ndarray:
    """Carrier-type map of data symbol l where symbol_in_cycle = l mod dy."""
    k_total = mode.k_total
    m = np.full(k_total, DATA, dtype=np.int8)
    # continual pilots
    m[_cp_positions(mode)] = CP
    # scattered pilots: (k - K_ext) mod (dx*dy) == dx*(l mod dy)
    k = np.arange(k_total)
    rem = np.mod(k - mode.k_ext, mode.dx * mode.dy)
    sp = rem == mode.dx * (symbol_in_cycle % mode.dy)
    m[sp] = SP
    if mode.papr in (Papr.TR, Papr.BOTH):
        m[_tr_positions(mode, symbol_in_cycle)] = TR_PAPR
    # edge pilots always present
    m[0] = EDGE
    m[k_total - 1] = EDGE
    return m


@functools.lru_cache(maxsize=None)
def fc_carrier_map(mode: T2Mode) -> np.ndarray:
    """Carrier-type map of the frame-closing symbol (clause 9.2.6)."""
    k_total = mode.k_total
    m = np.full(k_total, DATA, dtype=np.int8)
    k = np.arange(k_total)
    m[k % mode.dx == 0] = SP
    if mode.fft_size == 1024 and mode.pilot_pattern in (PilotPattern.PP4, PilotPattern.PP5):
        m[k_total - 2] = SP
    elif mode.fft_size == 2048 and mode.pilot_pattern == PilotPattern.PP7:
        m[k_total - 2] = SP
    if mode.papr in (Papr.TR, Papr.BOTH):
        papr = tables.carriers()[f"p2_papr_map_{_FFT_LABEL[mode.fft_size]}"]
        if mode.fft_size >= 8192:
            papr = papr + mode.k_ext
        m[papr] = TR_PAPR
    m[0] = EDGE
    m[k_total - 1] = EDGE
    return m


@functools.lru_cache(maxsize=None)
def _prbs_for(mode: T2Mode) -> np.ndarray:
    from . import prbs as _prbs
    return _prbs.pilot_prbs(mode.k_total + mode.k_offset)[mode.k_offset:]


@functools.lru_cache(maxsize=None)
def _pn_for(mode: T2Mode) -> np.ndarray:
    from . import prbs as _prbs
    return _prbs.frame_pn_sequence()


@functools.lru_cache(maxsize=None)
def miso_inversion_mask(mode: T2Mode, symbol_index: int) -> np.ndarray:
    """bool[k_total]: pilots transmit group 2 NEGATES on this symbol.

    Rules re-derived from the reference generator's MISO branches (see
    module docstring) and cross-validated against its compiled output for
    every carrier of every symbol (tests/test_reference_oracle.py).
    """
    l = symbol_index
    k_total = mode.k_total
    k = np.arange(k_total)
    inv = np.zeros(k_total, dtype=bool)
    if not mode.miso:
        return inv
    cmap = carrier_map_for_symbol(mode, l)
    if l < mode.n_p2:
        inv = (k % 3 == 0) & ((k // 3) % 2 == 1) & (cmap == P2)
        return inv
    if mode.has_fc and l == mode.frame_symbols - 1:
        inv = (k % mode.dx == 0) & ((k // mode.dx) % 2 == 1) & (cmap == SP)
        # edge parity: the reference uses (n_p2 + n_data) - 1 where its
        # n_data EXCLUDES the FC symbol (pilot_generator.cpp:2003)
        edge_inv = bool((mode.n_p2 + mode.n_data_symbols - 1 - 1) % 2)
        inv[0] = inv[k_total - 1] = edge_inv
        return inv
    # regular data symbol: SPs share one state, (k // dx) odd — equal to
    # the symbol's SP-column parity; CPs on SP-grid columns likewise
    inv = ((k % mode.dx == 0) & ((k // mode.dx) % 2 == 1)
           & ((cmap == SP) | (cmap == CP)))
    inv[0] = inv[k_total - 1] = bool(l % 2)
    return inv


def reference_symbol_tx(mode: T2Mode, symbol_index: int,
                        tx_group: int) -> np.ndarray:
    """Reference pilots as transmitted by MISO group 1 or 2."""
    ref = reference_symbol(mode, symbol_index)
    if tx_group == 1 or not mode.miso:
        return ref
    flip = 1.0 - 2.0 * miso_inversion_mask(mode, symbol_index)
    return (ref * flip).astype(np.float32)


def reference_symbol(mode: T2Mode, symbol_index: int) -> np.ndarray:
    """Real reference value per carrier for frame symbol ``symbol_index``.

    symbol_index counts OFDM symbols in the frame excluding P1 (0 .. L_F-1).
    Non-pilot carriers get 0.  Pilot cells carry +-A where the sign is
    r_k XOR pn_l (clause 9.2.2) and A is the per-type boost amplitude.
    """
    l = symbol_index
    if l < mode.n_p2:
        cmap = p2_carrier_map(mode)
    elif mode.has_fc and l == mode.frame_symbols - 1:
        cmap = fc_carrier_map(mode)
    else:
        cmap = data_carrier_map(mode, (l - 0) % mode.dy)
    r = _prbs_for(mode)
    pn = int(_pn_for(mode)[l])
    sign = 1.0 - 2.0 * np.bitwise_xor(r, pn).astype(np.float64)
    amp = np.zeros(mode.k_total)
    amp[cmap == P2] = mode.p2_amplitude
    amp[cmap == SP] = mode.sp_amplitude if (l >= mode.n_p2) else 0.0
    amp[cmap == EDGE] = mode.sp_amplitude
    amp[cmap == CP] = mode.cp_amplitude
    return (amp * sign).astype(np.float32)


def reference_frame(mode: T2Mode) -> np.ndarray:
    """[L_F, k_total] float32 reference pilots for a whole frame."""
    return np.stack([reference_symbol(mode, l) for l in range(mode.frame_symbols)])


def carrier_map_for_symbol(mode: T2Mode, symbol_index: int) -> np.ndarray:
    l = symbol_index
    if l < mode.n_p2:
        return p2_carrier_map(mode)
    if mode.has_fc and l == mode.frame_symbols - 1:
        return fc_carrier_map(mode)
    return data_carrier_map(mode, l % mode.dy)


def data_cell_indices(mode: T2Mode, symbol_index: int) -> np.ndarray:
    """Carrier indices holding payload cells for one symbol, in order."""
    cmap = carrier_map_for_symbol(mode, symbol_index)
    idx = np.nonzero(cmap == DATA)[0]
    return idx


def tr_cell_indices(mode: T2Mode, symbol_index: int) -> np.ndarray:
    """PAPR-reserved carrier indices for one symbol (clause 9.3.2): the
    tone-reservation kernel may place arbitrary energy here (amplitude
    cap 5); receivers must simply never read these cells."""
    cmap = carrier_map_for_symbol(mode, symbol_index)
    return np.nonzero((cmap == TR_PAPR) | (cmap == P2_PAPR))[0]
