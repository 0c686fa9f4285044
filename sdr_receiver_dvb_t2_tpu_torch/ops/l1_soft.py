"""Soft (FEC) L1 signalling decode: depuncture -> LDPC BP -> BCH correct.

The reference receiver hard-slices the systematic bits of L1-pre/post and
gates on CRC alone (reference/src/DVB_T2/p2_symbol.cpp:282-312) —
near threshold SNR the data path (full LDPC) decodes while acquisition
fails.  This framework owns LDPC decoders, so the L1 codes get the same
treatment: reconstruct the full SHORT_C1_4 / SHORT_C1_2 codeword LLRs
(known-zero padding pinned, punctured parity erased), run flooding BP
(ops/ldpc_decode, on the caller's device), then BCH-correct up to t=12
errors (params/bch), extending blind-acquisition reach by several dB.

Used as the fallback when the hard-decision path fails
(runtime/acquisition.py); the hard path stays first because it is free.

Padding/puncturing placement uses the EN 302 755 Table 17/18 group
orders in params/l1_fec.py (provenance + validation status documented
there), shared with the modulator so TX/RX agree by construction.  A
wrong order cannot cause a wrong accept — the CRC gates every candidate
— it would only cost the soft path's extra reach.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .. import resolve_device
from ..params import bch, l1_fec
from ..params.modes import Constellation
from . import ldpc_decode

_BIG = 96.0                      # pinned-known-bit LLR (int8-scale units)
_KSIG_PRE = 200
_KBCH_PRE = 3072
_KBCH_POST = 7032
_NBCH_PARITY = 168
L1_PRE_TX_BITS = l1_fec.L1_PRE_TX_BITS


@functools.lru_cache(maxsize=None)
def _decoder(table: str):
    return ldpc_decode.make_decoder(table, max_iters=30)


def cell_llrs(cells: np.ndarray, l1_post_mod: int, scale: float = 24.0
              ) -> np.ndarray:
    """Equalized L1 cells -> per-bit LLRs (positive = bit 0), matching the
    bit order of params.qam.hard_bits (i/q interleaved, MSB first)."""
    if l1_post_mod == 0:                       # BPSK
        return np.asarray(cells).real * scale
    from ..params.modes import BITS_PER_CELL, NORM_FACTOR
    const = {1: Constellation.QPSK, 2: Constellation.QAM16,
             3: Constellation.QAM64}.get(l1_post_mod)
    if const is None:           # reserved L1_POST mod code in a valid pre
        from ..params import l1 as _l1
        raise _l1.L1DecodeError(
            f"reserved L1_POST modulation {l1_post_mod}")
    eta = BITS_PER_CELL[const]
    per_axis = eta // 2
    c = np.asarray(cells) / NORM_FACTOR[const]
    planes = []
    for v in (c.real, c.imag):
        axis = [v * scale]                      # sign bit: positive -> 0
        r = np.abs(v)
        t = float(1 << (per_axis - 1))
        for _ in range(per_axis - 1):
            # hard bit is (r <= t); positive LLR = bit 0 = r > t
            axis.append((r - t) * scale)
            r = np.abs(r - t)
            t /= 2
        planes.append(np.stack(axis, axis=-1))
    inter = np.empty(c.shape + (eta,), dtype=np.float32)
    inter[..., 0::2] = planes[0]
    inter[..., 1::2] = planes[1]
    return inter.reshape(-1)


def _decode(table: str, llr_full: np.ndarray, k_bch: int, device):
    """Run BP on ``device`` + BCH correction on the host; returns
    corrected BCH-systematic bits or None when both LDPC parity and BCH
    correction fail."""
    llr = torch.from_numpy(llr_full[None, :]).to(resolve_device(device))
    hard, ok, _ = _decoder(table)(llr)
    hard = hard[0].cpu().numpy().astype(np.uint8)
    n_bch = k_bch + _NBCH_PARITY
    fixed, nerr = bch.decode(hard[:n_bch], 14)
    if nerr < 0 and not bool(ok[0]):
        return None
    return fixed if nerr >= 0 else hard[:n_bch]


def decode_l1_pre_fec(llr1840: np.ndarray, device=None
                      ) -> np.ndarray | None:
    """L1-pre soft decode: 1840 tx-bit LLRs -> 200 systematic bits.

    Padding/puncturing placement comes from params.l1_fec's group-order
    tables — the SAME orders the modulator uses (EN 302 755 Tables
    17/18; provenance documented in params/l1_fec.py)."""
    llr = np.clip(np.asarray(llr1840, np.float32), -_BIG, _BIG)
    assert llr.shape == (L1_PRE_TX_BITS,), llr.shape
    code = ldpc_decode.get_plan("SHORT_C1_4")
    full = np.zeros(code.n, dtype=np.float32)
    pos = l1_fec.info_bit_positions(_KBCH_PRE, _KSIG_PRE)
    full[:_KBCH_PRE] = _BIG                     # known zero padding ...
    full[pos] = llr[:_KSIG_PRE]                 # ... except the info bits
    full[_KBCH_PRE:_KBCH_PRE + _NBCH_PARITY] = \
        llr[_KSIG_PRE:_KSIG_PRE + _NBCH_PARITY]
    keep = L1_PRE_TX_BITS - _KSIG_PRE - _NBCH_PARITY
    keep_pos = l1_fec.parity_keep_positions(
        code.n - code.k, keep, l1_fec.L1_PRE_PUNCT_GROUP_ORDER)
    full[code.k + keep_pos] = llr[_KSIG_PRE + _NBCH_PARITY:]
    out = _decode("SHORT_C1_4", full, _KBCH_PRE, device)
    return None if out is None else out[pos]


def decode_l1_post_fec(llr_coded: np.ndarray, k_sig: int, device=None
                       ) -> np.ndarray | None:
    """L1-post soft decode: N_post coded-bit LLRs (FEC order, i.e. after
    undoing the column interleave/demux) -> k_sig info bits.

    Same group-order hooks as the L1-pre path (params/l1_fec.py)."""
    llr = np.clip(np.asarray(llr_coded, np.float32), -_BIG, _BIG)
    code = ldpc_decode.get_plan("SHORT_C1_2")
    full = np.zeros(code.n, dtype=np.float32)
    pos = l1_fec.info_bit_positions(_KBCH_POST, k_sig,
                                    l1_fec.L1_POST_PAD_GROUP_ORDER)
    full[:_KBCH_POST] = _BIG                    # known zero padding ...
    full[pos] = llr[:k_sig]                     # ... except the info bits
    full[_KBCH_POST:_KBCH_POST + _NBCH_PARITY] = \
        llr[k_sig:k_sig + _NBCH_PARITY]
    keep = len(llr) - k_sig - _NBCH_PARITY
    keep_pos = l1_fec.parity_keep_positions(
        code.n - code.k, keep, l1_fec.L1_POST_PUNCT_GROUP_ORDER)
    full[code.k + keep_pos] = llr[k_sig + _NBCH_PARITY:]
    out = _decode("SHORT_C1_2", full, _KBCH_POST, device)
    return None if out is None else out[pos]
