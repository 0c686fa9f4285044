"""Pseudo-random sequences used throughout DVB-T2 (ETSI EN 302 755).

All generators are implemented from the standard's shift-register definitions
and verified in tests against spec-mandated invariants.  Reference
counterparts for parity checking: pilot PRBS reference/src/DVB_T2/
pilot_generator.cpp:28-46, frame PN unpack ibid:40-45, BB/L1 scrambler
reference/src/DVB_T2/bch_decoder.cpp:47-58, P1 MSS randomizer
reference/src/DVB_T2/p1_symbol.cpp:45-55.
"""
from __future__ import annotations

import functools
import numpy as np

from . import tables


def pilot_prbs(length: int) -> np.ndarray:
    """Carrier-wise pilot modulation PRBS r_k (EN 302 755 clause 9.2.1).

    11-bit shift register, polynomial X^11 + X^2 + 1, init all-ones; the
    output bit is the register LSB before each shift.
    """
    out = np.empty(length, dtype=np.uint8)
    sr = 0x7FF
    for i in range(length):
        out[i] = sr & 1
        b = (sr ^ (sr >> 2)) & 1
        sr = (sr >> 1) | (b << 10)
    return out


@functools.lru_cache(maxsize=None)
def frame_pn_sequence() -> np.ndarray:
    """Frame-level PN sequence pn_l, 2624 chips (EN 302 755 table 41)."""
    packed = tables.carriers()["pn_sequence_bytes"]
    bits = np.unpackbits(packed.astype(np.uint8))
    return bits


def bb_scrambler(length: int) -> np.ndarray:
    """BB frame scrambler PRBS (EN 302 755 clause 5.2.4).

    15-bit register, 1 + X^14 + X^15, init 100101010000000.
    """
    out = np.empty(length, dtype=np.uint8)
    sr = 0x4A80
    for i in range(length):
        b = (sr ^ (sr >> 1)) & 1
        out[i] = b
        sr >>= 1
        if b:
            sr |= 0x4000
    return out


# The L1-post scrambler uses the same PRBS as the BB scrambler
# (EN 302 755 clause 7.3.1.2)
l1_scrambler = bb_scrambler


def p1_mss_randomizer() -> np.ndarray:
    """P1 signalling scrambling sequence, 384 chips (EN 302 755 clause 9.8.2.5).

    14-bit register polynomial per the spec's SRS definition, seed 0x4e46;
    returned as +-1 values multiplying the DBPSK chip sequence.
    """
    out = np.empty(384, dtype=np.int8)
    sr = 0x4E46
    for i in range(384):
        b = (sr ^ (sr >> 1)) & 1
        out[i] = 1 if b == 0 else -1
        sr >>= 1
        if b:
            sr |= 0x4000
    return out
