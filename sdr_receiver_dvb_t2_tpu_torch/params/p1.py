"""P1 preamble symbol: generation and signalling decode.

ETSI EN 302 755 clause 9.8: the P1 symbol is a 1K OFDM symbol (A, 1024
samples) with frequency-shifted guard copies (C = first 542 samples, B =
last 482 samples, both shifted by f_SH = 1/(1024T)), transmitted as
[C | A | B] = 2048 samples.  384 active carriers (CDS table) carry the
S1 (3 bits) and S2 (4 bits) fields as CSS pattern sequences, scrambled and
DBPSK-modulated.

The reference decoder is reference/src/DVB_T2/p1_symbol.cpp:184-301;
conventions here (starting DBPSK state, pattern layout S1|S2|S1) match it.
"""
from __future__ import annotations

import functools
import numpy as np

from . import tables, prbs

P1_LEN = 2048
P1_A = 1024
P1_C = 542
P1_B = 482
FIRST_ACTIVE_CARRIER = 86      # index of CDS carrier 0 in the shifted 1K FFT
ACTIVE = 384


@functools.lru_cache(maxsize=None)
def _patterns():
    t = tables.carriers()
    s1 = np.unpackbits(t["s1_patterns"].astype(np.uint8), axis=1)   # [8, 64]
    s2 = np.unpackbits(t["s2_patterns"].astype(np.uint8), axis=1)   # [16, 256]
    return s1, s2


def signalling_bits(s1: int, s2: int) -> np.ndarray:
    """384-bit pattern sequence: S1 pattern | S2 pattern | S1 pattern."""
    s1p, s2p = _patterns()
    return np.concatenate([s1p[s1], s2p[s2], s1p[s1]]).astype(np.uint8)


def modulate_carriers(s1: int, s2: int) -> np.ndarray:
    """+-1 DBPSK chip per active carrier (scrambled MSS sequence)."""
    bits = signalling_bits(s1, s2)
    m = np.empty(ACTIVE, dtype=np.int8)
    prev = 1
    for i in range(ACTIVE):
        prev = -prev if bits[i] else prev
        m[i] = prev
    d = m * prbs.p1_mss_randomizer()
    # The decoder reconstructs the chip sequence from transitions only and
    # assumes d[0] == -1 (p1_symbol.cpp:194-195); every S1 pattern starts
    # with bit 0 and the scrambler starts with -1, so this always holds.
    assert d[0] == -1
    return d.astype(np.int8)


def active_carrier_bins() -> np.ndarray:
    """Baseband FFT bin indices (possibly negative) of the active carriers."""
    cds = tables.carriers()["p1_active_carriers"]
    return cds + FIRST_ACTIVE_CARRIER - P1_A // 2


def generate(s1: int, s2: int) -> np.ndarray:
    """Generate one 2048-sample P1 symbol (complex64, unit average power)."""
    chips = modulate_carriers(s1, s2)
    spec = np.zeros(P1_A, dtype=np.complex64)
    bins = np.mod(active_carrier_bins(), P1_A)
    spec[bins] = chips.astype(np.float32)
    a = np.fft.ifft(spec) * (P1_A / np.sqrt(ACTIVE))
    n = np.arange(P1_A)
    shift = np.exp(2j * np.pi * n / P1_A)
    c = a[:P1_C] * shift[:P1_C]
    b = a[P1_C:] * shift[P1_C:]
    return np.concatenate([c, a, b]).astype(np.complex64)


def decode_a_spectrum(spec_shifted: np.ndarray) -> tuple[int, int, int] | None:
    """Decode S1/S2 from an fft-shifted 1024-bin spectrum of the A part.

    Searches integer carrier offsets of +-10 bins (~ +-90 kHz at 8 MHz) like
    the reference (p1_symbol.cpp:117-126).  Returns (s1, s2, offset_bins) or
    None if no pattern matches.
    """
    cds = tables.carriers()["p1_active_carriers"]
    rand = prbs.p1_mss_randomizer()
    s1p, s2p = _patterns()
    cand = None
    for off in range(-10, 10):
        vals = spec_shifted[cds + FIRST_ACTIVE_CARRIER + off]
        # differential detection
        dif = vals[1:] * np.conj(vals[:-1])
        flip = np.abs(np.angle(dif)) > np.pi / 2
        d = np.empty(ACTIVE, dtype=np.int8)
        d[0] = -1
        state = -1
        for i in range(1, ACTIVE):
            state = -state if flip[i - 1] else state
            d[i] = state
        m = d * rand
        bits = np.empty(ACTIVE, dtype=np.uint8)
        prev = 1
        for i in range(ACTIVE):
            bits[i] = 0 if m[i] == prev else 1
            prev = m[i]
        # minimum-Hamming-distance decode with a confidence threshold:
        # exact equality is brittle under multipath (a channel notch flips
        # isolated DBPSK chips); the S1 field is transmitted twice, so
        # both copies vote.  The reference matches patterns by maximum
        # correlation for the same reason (p1_symbol.cpp:184-301).  Random
        # noise sits at ~50% distance, far above the 20% accept threshold
        # (the false-alarm test in test_frontend.py pins this).
        d1 = ((s1p != bits[None, :64]).sum(axis=1)
              + (s1p != bits[None, 320:]).sum(axis=1))        # of 128
        d2 = (s2p != bits[None, 64:320]).sum(axis=1)          # of 256
        if d1.min() <= 0.2 * 128 and d2.min() <= 0.2 * 256:
            best = (int(np.argmin(d1)), int(np.argmin(d2)), off,
                    int(d1.min() + d2.min()))
            if best[3] == 0:
                return best[:3]
            if cand is None or best[3] < cand[3]:
                cand = best
    return cand[:3] if cand is not None else None
