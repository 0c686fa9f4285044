"""In-band signalling (EN 302 755 clause 5.2.3): L1-dynamic in the data path.

When a PLP's ``IN_BAND_A_FLAG`` is set, the first BB frame of each
Interleaving Frame carries an in-band type A block at the start of its
padding field (the BB header's DFL leaves room for it).  The block signals
the NEXT interleaving frame's dynamic schedule — SUB_SLICE_INTERVAL,
PLP_START and PLP_NUM_BLOCKS for the current PLP plus any other PLPs
"in band" — so a receiver that is decoding data can track schedule
changes without re-reading the P2 L1-post every frame.

The reference parses and displays the IN_BAND_A/B flags only
(reference/src/DVB_T2/p2_symbol.cpp:772-773) and never opens the
padding field; this module implements the actual signalling for both the
TX fixture and the receiver's L1-dynamic tracker (runtime/stream.py).

Field order/widths follow EN 302 755 clause 5.2.3.1 (in-band type A);
widths are kept bit-compatible with this package's L1-dynamic loop
(params/l1.py L1_DYN_PLP_FIELDS: 22-bit starts, 10-bit block counts).
In-band blocks carry no CRC of their own — they ride inside the
BCH+LDPC-protected BB frame — so the parser validates structure
(PADDING_TYPE, zeroed reserved fields, field ranges) before a block is
believed.
"""
from __future__ import annotations

import dataclasses
import numpy as np

PADDING_TYPE_A = 0b00
PADDING_TYPE_B = 0b01

# (field, width) in transmission order — clause 5.2.3.1
INBAND_A_HEAD = [
    ("padding_type", 2),
    ("plp_l1_change_counter", 8),
    ("reserved_1", 8),
    ("sub_slice_interval", 22),
    ("start_rf_idx", 3),
    ("current_plp_start", 22),
    ("current_plp_num_blocks", 10),
    ("num_other_plp_in_band", 8),
]
INBAND_A_OTHER = [
    ("plp_id", 8),
    ("plp_start", 22),
    ("plp_num_blocks", 10),
    ("reserved_3", 2),
]
INBAND_A_TAIL = [("reserved_4", 8)]

_HEAD_BITS = sum(w for _, w in INBAND_A_HEAD)
_OTHER_BITS = sum(w for _, w in INBAND_A_OTHER)
_TAIL_BITS = sum(w for _, w in INBAND_A_TAIL)


def inband_a_bits(n_other: int) -> int:
    """Length in bits of an in-band A block signalling n_other other PLPs."""
    return _HEAD_BITS + n_other * _OTHER_BITS + _TAIL_BITS


@dataclasses.dataclass
class InBandOtherPlp:
    plp_id: int = 0
    plp_start: int = 0
    plp_num_blocks: int = 0
    reserved_3: int = 0


@dataclasses.dataclass
class InBandA:
    """One in-band type A block: the NEXT interleaving frame's schedule."""
    padding_type: int = PADDING_TYPE_A
    plp_l1_change_counter: int = 0
    reserved_1: int = 0
    sub_slice_interval: int = 0
    start_rf_idx: int = 0
    current_plp_start: int = 0
    current_plp_num_blocks: int = 0
    num_other_plp_in_band: int = 0
    other: list = dataclasses.field(default_factory=list)
    reserved_4: int = 0

    def starts_blocks(self, current_plp_id: int):
        """{plp_id: (start, num_blocks)} for every PLP the block covers."""
        out = {current_plp_id: (self.current_plp_start,
                                self.current_plp_num_blocks)}
        for o in self.other:
            out[o.plp_id] = (o.plp_start, o.plp_num_blocks)
        return out


def build_inband_a(block: InBandA) -> np.ndarray:
    """InBandA -> uint8 bit array (padding-field prefix, MSB-first)."""
    from ..params.l1 import _BitWriter
    w = _BitWriter()
    block.num_other_plp_in_band = len(block.other)
    w.put_fields(block, INBAND_A_HEAD)
    for o in block.other:
        w.put_fields(o, INBAND_A_OTHER)
    w.put_fields(block, INBAND_A_TAIL)
    return w.array()


def parse_inband_a(padding_bits: np.ndarray) -> InBandA | None:
    """Padding-field bits -> InBandA, or None if no plausible block.

    Validation (the block is CRC-less): PADDING_TYPE must be type A,
    reserved fields zero, the other-PLP count must fit the padding field,
    and the block must not be all-zero (an empty padding field scrambles
    to zeros and would otherwise parse as a degenerate type-A block).
    """
    from ..params.l1 import _BitReader
    bits = np.asarray(padding_bits, dtype=np.uint8)
    if len(bits) < _HEAD_BITS + _TAIL_BITS or not bits.any():
        return None
    r = _BitReader(bits)
    blk = InBandA()
    r.get_fields(blk, INBAND_A_HEAD)
    if blk.padding_type != PADDING_TYPE_A or blk.reserved_1 != 0:
        return None
    n = blk.num_other_plp_in_band
    if len(bits) < inband_a_bits(n):
        return None
    for _ in range(n):
        o = InBandOtherPlp()
        r.get_fields(o, INBAND_A_OTHER)
        if o.reserved_3 != 0:
            return None
        blk.other.append(o)
    r.get_fields(blk, INBAND_A_TAIL)
    if blk.reserved_4 != 0:
        return None
    if blk.current_plp_num_blocks == 0 and not blk.other:
        return None                     # degenerate / stale zero block
    return blk
