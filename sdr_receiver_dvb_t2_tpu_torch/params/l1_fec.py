"""L1 signalling FEC: shortened BCH + punctured LDPC + L1 interleaving.

ETSI EN 302 755 clause 7.3: L1-pre is protected by BCH(3072 info, GF(2^14))
+ LDPC 16200 rate 1/4, punctured to exactly 1840 transmitted bits (BPSK).
L1-post uses BCH(7032) + LDPC 16200 rate 1/2 with puncturing sized by the
6/5 rule, then (for 16/64-QAM) a column interleaver without twist and the
bit-to-cell demux.

Padding/puncturing group orders (EN 302 755 Tables 17/18): the spec
scatters zero-padding across specific bit groups and punctures parity in
a specific group order.  The `*_GROUP_ORDER` constants below carry those
orders (provenance and validation status documented at their definition);
the modulator and the soft depuncture (ops/l1_soft) both route through
`info_bit_positions`/`parity_keep_positions`, so TX and RX stay
consistent by construction.  The systematic K_sig information bits are
always transmitted first and un-padded (clause 7.3.2.2 removes padding
before transmission), so the HARD-decision L1 decode — the only path the
reference has (reference/src/DVB_T2/p2_symbol.cpp:282-312,514-648)
— does not depend on these orders at all; only the soft FEC fallback's
extra reach does.
"""
from __future__ import annotations

import math
import numpy as np

from . import bch, ldpc, tables, prbs
from .modes import Constellation

L1_PRE_TX_BITS = 1840
_KSIG_PRE = 200
_KBCH_PRE = 3072          # BCH short, t=12, GF(2^14)
_KBCH_POST = 7032
_NBCH_PARITY = 168

ETA_L1 = {0: 1, 1: 2, 2: 4, 3: 6}   # L1_POST_MOD -> bits/cell

# --- EN 302 755 Table 17/18 group orders ----------------------------------
# Padding group order for L1-post (Table 17: 20 groups of the 7200-bit
# K_ldpc info block) and parity puncturing orders for L1-pre (36 groups of
# the rate-1/4 code's 12960 parity bits) and L1-post (25 groups of the
# rate-1/2 code's 9000 parity bits).  The ETSI text is not available in
# this build environment; these are the orders every public DVB-T2
# modulator/receiver implements (e.g. GNU Radio gr-dtv's dvbt2
# framemapper), structure-validated here: each is a permutation of the
# right group count, and the L1-pre puncture budget 12960-1472 = 11488 =
# 31 full groups + 328 bits reproduces the spec's "31 groups and the
# first 328 bits of the 32nd" rule (clause 7.3.2.3.1); they have not been
# validated against an off-air capture in this environment (none exists
# here).  BOTH the modulator and the soft depuncture route through the
# two functions below, so TX/RX stay consistent by construction.
# Setting any of these to None falls back to the tail convention.
L1_POST_PAD_GROUP_ORDER: "list[int] | None" = [
    18, 17, 16, 15, 14, 13, 12, 11, 4, 10,
    9, 8, 3, 2, 7, 6, 5, 1, 19, 0]
L1_PRE_PUNCT_GROUP_ORDER: "list[int] | None" = [
    27, 13, 29, 32, 5, 0, 11, 21, 33, 20, 25, 28,
    18, 35, 8, 3, 9, 31, 22, 24, 7, 14, 17, 4,
    2, 26, 16, 34, 19, 10, 12, 23, 1, 6, 30, 15]
L1_POST_PUNCT_GROUP_ORDER: "list[int] | None" = [
    6, 4, 18, 9, 13, 8, 15, 20, 5, 17, 2, 24, 10,
    22, 12, 3, 16, 23, 1, 14, 0, 21, 19, 7, 11]
_GROUP = 360


def info_bit_positions(k_bch: int, k_sig: int, order=None) -> np.ndarray:
    """Sorted positions within the K_bch info block that carry the K_sig
    transmitted signalling bits (the rest are zero padding).

    With a Table-17 ``order`` the first floor(n_pad/360) groups of the
    order are fully padded and the remainder pads the next group's tail;
    info bits fill the remaining positions in natural order (the spec
    transmits them in that order after removing the padding)."""
    n_pad = k_bch - k_sig
    if order is None:
        return np.arange(k_sig)
    pad = np.zeros(k_bch, dtype=bool)
    full, rem = divmod(n_pad, _GROUP)
    for g in order[:full]:
        pad[g * _GROUP:(g + 1) * _GROUP] = True
    if rem:
        g = order[full]
        pad[g * _GROUP: g * _GROUP + rem] = True
    return np.nonzero(~pad)[0][:k_sig]


def parity_keep_positions(n_parity: int, keep: int, order=None) -> np.ndarray:
    """Sorted positions of the LDPC parity bits that SURVIVE puncturing.

    With a Table-18 ``order`` the first floor(n_punc/360) groups of the
    order are fully punctured and the remainder punctures the next group's
    head; survivors transmit in natural order."""
    n_punc = n_parity - keep
    if order is None:
        return np.arange(keep)
    punct = np.zeros(n_parity, dtype=bool)
    full, rem = divmod(n_punc, _GROUP)
    for g in order[:full]:
        punct[g * _GROUP:(g + 1) * _GROUP] = True
    if rem:
        g = order[full]
        punct[g * _GROUP: g * _GROUP + rem] = True
    return np.nonzero(~punct)[0][:keep]


def l1_post_sizes(k_sig: int, l1_post_mod: int, n_p2: int) -> tuple[int, int]:
    """(N_post bits, N_punc) per EN 302 755 clause 7.3.2.3."""
    n_punc_temp = (6 * (_KBCH_POST - k_sig)) // 5
    n_post_temp = k_sig + _NBCH_PARITY + 9000 - n_punc_temp
    eta = ETA_L1[l1_post_mod]
    block = 2 * eta * n_p2
    n_post = math.ceil(n_post_temp / block) * block
    n_punc = n_punc_temp - (n_post - n_post_temp)
    return n_post, n_punc


def encode_l1_pre(bits200: np.ndarray) -> np.ndarray:
    """200 info bits -> 1840 transmitted bits (before BPSK mapping)."""
    bits200 = np.asarray(bits200, dtype=np.uint8)
    assert bits200.shape == (_KSIG_PRE,)
    padded = np.zeros(_KBCH_PRE, dtype=np.uint8)
    padded[info_bit_positions(_KBCH_PRE, _KSIG_PRE)] = bits200
    bch_cw = bch.encode(padded, 14)                       # 3240 bits
    code = ldpc.get_code("SHORT_C1_4")
    assert code.k == len(bch_cw), (code.k, len(bch_cw))
    ldpc_cw = code.encode(bch_cw)
    parity = ldpc_cw[code.k:]
    keep_parity = L1_PRE_TX_BITS - _KSIG_PRE - _NBCH_PARITY
    keep_pos = parity_keep_positions(len(parity), keep_parity,
                                     L1_PRE_PUNCT_GROUP_ORDER)
    tx = np.concatenate([
        bits200,
        bch_cw[_KBCH_PRE:],                               # BCH parity
        parity[keep_pos],                                 # punctured LDPC parity
    ])
    assert len(tx) == L1_PRE_TX_BITS
    return tx


def encode_l1_post(info_bits: np.ndarray, l1_post_mod: int, n_p2: int,
                   scrambled: bool = False) -> np.ndarray:
    """info+CRC bits (K_sig) -> N_post coded bits in transmission order.

    Includes the L1 column interleaver (no twist) and bit-to-cell demux for
    16/64-QAM; output bits map directly onto cells eta at a time.
    """
    info_bits = np.asarray(info_bits, dtype=np.uint8)
    k_sig = len(info_bits)
    assert k_sig <= _KBCH_POST, "multi-block L1-post not supported yet"
    n_post, n_punc = l1_post_sizes(k_sig, l1_post_mod, n_p2)

    if scrambled:
        info_bits = info_bits ^ prbs.l1_scrambler(k_sig)

    padded = np.zeros(_KBCH_POST, dtype=np.uint8)
    padded[info_bit_positions(_KBCH_POST, k_sig,
                              L1_POST_PAD_GROUP_ORDER)] = info_bits
    bch_cw = bch.encode(padded, 14)                       # 7200 bits
    code = ldpc.get_code("SHORT_C1_2")
    assert code.k == len(bch_cw)
    ldpc_cw = code.encode(bch_cw)
    parity = ldpc_cw[code.k:]
    keep_parity = n_post - k_sig - _NBCH_PARITY
    keep_pos = parity_keep_positions(len(parity), keep_parity,
                                     L1_POST_PUNCT_GROUP_ORDER)
    u = np.concatenate([info_bits, bch_cw[_KBCH_POST:], parity[keep_pos]])
    assert len(u) == n_post

    eta = ETA_L1[l1_post_mod]
    if eta <= 2:
        return u
    # column interleave (no twist) + demux, mirroring the RX inverse at
    # p2_symbol.cpp:599-626
    cols = 2 * eta
    rows = n_post // cols
    i = np.arange(n_post)
    v = u[(i % cols) * rows + i // cols]
    mux = tables.carriers()["mux16" if eta == 4 else "mux64"]
    group = (i // cols) * cols
    stream = v[group + mux[i % cols]]
    return stream


def decode_l1_pre_systematic(bits1840: np.ndarray):
    """Extract the 200 systematic bits (reference-style hard path)."""
    return np.asarray(bits1840)[:_KSIG_PRE]


def undo_l1_post_interleave(stream_bits: np.ndarray, l1_post_mod: int) -> np.ndarray:
    """Invert demux + column interleave, returning coded bits in FEC order."""
    stream_bits = np.asarray(stream_bits, dtype=np.uint8)
    eta = ETA_L1[l1_post_mod]
    if eta <= 2:
        return stream_bits
    n_post = len(stream_bits)
    cols = 2 * eta
    rows = n_post // cols
    i = np.arange(n_post)
    mux = tables.carriers()["mux16" if eta == 4 else "mux64"]
    v = np.empty_like(stream_bits)
    group = (i // cols) * cols
    v[group + mux[i % cols]] = stream_bits
    u = np.empty_like(v)
    u[(i % cols) * rows + i // cols] = v
    return u


def undo_l1_post_interleave_soft(stream_llr: np.ndarray,
                                 l1_post_mod: int) -> np.ndarray:
    """Same permutation applied to float LLRs (the soft FEC path)."""
    stream_llr = np.asarray(stream_llr, dtype=np.float32)
    eta = ETA_L1[l1_post_mod]
    if eta <= 2:
        return stream_llr
    n_post = len(stream_llr)
    cols = 2 * eta
    rows = n_post // cols
    i = np.arange(n_post)
    mux = tables.carriers()["mux16" if eta == 4 else "mux64"]
    v = np.empty_like(stream_llr)
    group = (i // cols) * cols
    v[group + mux[i % cols]] = stream_llr
    u = np.empty_like(v)
    u[(i % cols) * rows + i // cols] = v
    return u
