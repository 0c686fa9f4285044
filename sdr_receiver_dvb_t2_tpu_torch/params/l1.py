"""L1 signalling: bit formats, CRC32, build (TX) and parse (RX).

ETSI EN 302 755 clause 7: the P2 symbols carry L1-pre signalling (200 bits
incl. CRC32, fixed 1840 BPSK cells) followed by L1-post signalling
(configurable + dynamic (+ optional dyn-next) + CRC32, modulated
BPSK/QPSK/16/64-QAM).  Field widths follow EN 302 755 V1.3.1 tables;
the reference parser at reference/src/DVB_T2/p2_symbol.cpp:282-1073
reads the same layout.

Declarative field lists keep build and parse in lockstep; everything is
host-side Python/NumPy (L1 parsing happens once per frame).
"""
from __future__ import annotations

import dataclasses
import numpy as np

CRC32_POLY = 0x04C11DB7
L1_PRE_BITS = 200          # 168 info + 32 CRC
L1_PRE_CELLS = 1840


class L1DecodeError(ValueError):
    """A CRC-valid L1 block carries out-of-spec field values (e.g. a
    reserved L1_POST modulation code).  Distinguishes malformed *signal*
    from programming errors: the streaming tracker treats this as an
    erasure (repairable from in-band / repetition caches) while any other
    exception propagates as a bug (runtime/stream._check_l1_dynamic)."""

# (field_name, bit_width) in transmission order
L1_PRE_FIELDS = [
    ("type", 8), ("bwt_ext", 1), ("s1", 3), ("s2_field1", 3), ("s2_field2", 1),
    ("l1_repetition_flag", 1), ("guard_interval", 3), ("papr", 4),
    ("l1_post_mod", 4), ("l1_cod", 2), ("l1_fec_type", 2),
    ("l1_post_size", 18), ("l1_post_info_size", 18), ("pilot_pattern", 4),
    ("tx_id_availability", 8), ("cell_id", 16), ("network_id", 16),
    ("t2_system_id", 16), ("num_t2_frames", 8), ("num_data_symbols", 12),
    ("regen_flag", 3), ("l1_post_extension", 1), ("num_rf", 3),
    ("current_rf_index", 3), ("t2_version", 4), ("l1_post_scrambled", 1),
    ("t2_base_lite", 1), ("reserved", 4),
]
assert sum(w for _, w in L1_PRE_FIELDS) == 168

L1_POST_HEADER_FIELDS = [
    ("sub_slices_per_frame", 15), ("num_plp", 8), ("num_aux", 4),
    ("aux_config_rfu", 8),
]
L1_POST_RF_FIELDS = [("rf_idx", 3), ("frequency", 32)]
L1_POST_FEF_FIELDS = [("fef_type", 4), ("fef_length", 22), ("fef_interval", 8)]
L1_POST_PLP_FIELDS = [
    ("id", 8), ("plp_type", 3), ("plp_payload_type", 5), ("ff_flag", 1),
    ("first_rf_idx", 3), ("first_frame_idx", 8), ("plp_group_id", 8),
    ("plp_cod", 3), ("plp_mod", 3), ("plp_rotation", 1), ("plp_fec_type", 2),
    ("plp_num_blocks_max", 10), ("frame_interval", 8), ("time_il_length", 8),
    ("time_il_type", 1), ("in_band_a_flag", 1), ("in_band_b_flag", 1),
    ("reserved_1", 11), ("plp_mode", 2), ("static_flag", 1),
    ("static_padding_flag", 1),
]
assert sum(w for _, w in L1_POST_PLP_FIELDS) == 89
L1_POST_TRAILER_FIELDS = [("fef_length_msb", 2), ("reserved_2", 30)]
L1_POST_AUX_FIELDS = [("aux_stream_type", 4), ("aux_private_conf", 28)]
L1_DYN_FIELDS = [
    ("frame_idx", 8), ("sub_slice_interval", 22), ("type_2_start", 22),
    ("l1_change_counter", 8), ("start_rf_idx", 3), ("reserved_1", 8),
]
assert sum(w for _, w in L1_DYN_FIELDS) == 71
L1_DYN_PLP_FIELDS = [
    ("id", 8), ("start", 22), ("num_blocks", 10), ("reserved_2", 8),
]
assert sum(w for _, w in L1_DYN_PLP_FIELDS) == 48


def crc32(bits: np.ndarray) -> int:
    """MPEG CRC32 (poly 0x04C11DB7, init all-ones, no reflection/xor-out)."""
    crc = 0xFFFFFFFF
    for bit in np.asarray(bits, dtype=np.uint8):
        b = int(bit) ^ ((crc >> 31) & 1)
        crc = (crc << 1) & 0xFFFFFFFF
        if b:
            crc ^= CRC32_POLY
    return crc


class _BitWriter:
    def __init__(self):
        self.bits = []

    def put(self, value: int, width: int):
        v = int(value)
        assert 0 <= v < (1 << width), (v, width)
        self.bits.extend((v >> s) & 1 for s in range(width - 1, -1, -1))

    def put_fields(self, obj, fields):
        for name, width in fields:
            self.put(getattr(obj, name), width)

    def array(self):
        return np.array(self.bits, dtype=np.uint8)


class _BitReader:
    def __init__(self, bits):
        self.bits = np.asarray(bits, dtype=np.uint8)
        self.pos = 0

    def get(self, width: int) -> int:
        v = 0
        for b in self.bits[self.pos:self.pos + width]:
            v = (v << 1) | int(b)
        self.pos += width
        return v

    def get_fields(self, obj, fields):
        for name, width in fields:
            setattr(obj, name, self.get(width))


@dataclasses.dataclass
class L1Pre:
    type: int = 3                 # TS only
    bwt_ext: int = 1
    s1: int = 0                   # T2_SISO
    s2_field1: int = 5            # 32K
    s2_field2: int = 0
    l1_repetition_flag: int = 0
    guard_interval: int = 4       # 1/128
    papr: int = 0
    l1_post_mod: int = 1          # QPSK
    l1_cod: int = 0               # rate 1/2 (only defined value)
    l1_fec_type: int = 0          # LDPC 16K
    l1_post_size: int = 0         # coded+modulated cells
    l1_post_info_size: int = 0
    pilot_pattern: int = 6        # PP7
    tx_id_availability: int = 0
    cell_id: int = 0
    network_id: int = 0x3085
    t2_system_id: int = 0x8001
    num_t2_frames: int = 2
    num_data_symbols: int = 59
    regen_flag: int = 0
    l1_post_extension: int = 0
    num_rf: int = 1
    current_rf_index: int = 0
    t2_version: int = 1           # V1.2.1
    l1_post_scrambled: int = 0
    t2_base_lite: int = 0
    reserved: int = 0
    crc_32: int = 0


@dataclasses.dataclass
class L1PostRf:
    rf_idx: int = 0
    frequency: int = 698000000


@dataclasses.dataclass
class L1PostPlp:
    id: int = 0
    plp_type: int = 1
    plp_payload_type: int = 3     # TS
    ff_flag: int = 0
    first_rf_idx: int = 0
    first_frame_idx: int = 0
    plp_group_id: int = 0
    plp_cod: int = 2              # 2/3
    plp_mod: int = 3              # 256QAM
    plp_rotation: int = 1
    plp_fec_type: int = 1         # normal
    plp_num_blocks_max: int = 10
    frame_interval: int = 1
    time_il_length: int = 3
    time_il_type: int = 0
    in_band_a_flag: int = 0
    in_band_b_flag: int = 0
    reserved_1: int = 0
    plp_mode: int = 2             # HEM
    static_flag: int = 0
    static_padding_flag: int = 0


@dataclasses.dataclass
class L1DynPlp:
    id: int = 0
    start: int = 0
    num_blocks: int = 0
    reserved_2: int = 0


@dataclasses.dataclass
class L1Dyn:
    frame_idx: int = 0
    sub_slice_interval: int = 0
    type_2_start: int = 0
    l1_change_counter: int = 0
    start_rf_idx: int = 0
    reserved_1: int = 0
    plp: list = dataclasses.field(default_factory=list)
    reserved_3: int = 0
    aux_private_dyn: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class L1Post:
    sub_slices_per_frame: int = 1
    num_plp: int = 1
    num_aux: int = 0
    aux_config_rfu: int = 0
    rf: list = dataclasses.field(default_factory=lambda: [L1PostRf()])
    fef_type: int = 0
    fef_length: int = 0
    fef_interval: int = 0
    plp: list = dataclasses.field(default_factory=lambda: [L1PostPlp()])
    fef_length_msb: int = 0
    reserved_2: int = 0
    aux: list = dataclasses.field(default_factory=list)
    dyn: L1Dyn = dataclasses.field(default_factory=L1Dyn)
    dyn_next: L1Dyn = dataclasses.field(default_factory=L1Dyn)


# ---------------------------------------------------------------------------
# build (TX)
# ---------------------------------------------------------------------------

def build_l1_pre(pre: L1Pre) -> np.ndarray:
    """200-bit L1-pre including CRC32."""
    w = _BitWriter()
    w.put_fields(pre, L1_PRE_FIELDS)
    bits = w.array()
    crc = crc32(bits)
    pre.crc_32 = crc
    w.put(crc, 32)
    return w.array()


def _dyn_bits(w: _BitWriter, dyn: L1Dyn, num_plp: int, num_aux: int):
    w.put_fields(dyn, L1_DYN_FIELDS)
    for i in range(num_plp):
        w.put_fields(dyn.plp[i], L1_DYN_PLP_FIELDS)
    w.put(dyn.reserved_3, 8)
    for i in range(num_aux):
        w.put(dyn.aux_private_dyn[i], 48)


def build_l1_post_info(post: L1Post, pre: L1Pre) -> np.ndarray:
    """L1-post configurable+dynamic(+dyn_next) bits followed by CRC32."""
    w = _BitWriter()
    w.put_fields(post, L1_POST_HEADER_FIELDS)
    for rf in post.rf:
        w.put_fields(rf, L1_POST_RF_FIELDS)
    if pre.s2_field2:
        w.put_fields(post, L1_POST_FEF_FIELDS)
    for plp in post.plp:
        w.put_fields(plp, L1_POST_PLP_FIELDS)
    w.put_fields(post, L1_POST_TRAILER_FIELDS)
    for aux in post.aux:
        w.put_fields(aux, L1_POST_AUX_FIELDS)
    _dyn_bits(w, post.dyn, post.num_plp, post.num_aux)
    if pre.l1_repetition_flag:
        _dyn_bits(w, post.dyn_next, post.num_plp, post.num_aux)
    bits = w.array()
    crc = crc32(bits)
    w.put(crc, 32)
    return w.array()


# ---------------------------------------------------------------------------
# parse (RX)
# ---------------------------------------------------------------------------

def parse_l1_pre(bits: np.ndarray) -> L1Pre | None:
    """Parse 200 hard bits; returns None on CRC32 mismatch."""
    bits = np.asarray(bits, dtype=np.uint8)
    if crc32(bits[:168]) != int(_BitReader(bits[168:200]).get(32)):
        return None
    pre = L1Pre()
    _BitReader(bits).get_fields(pre, L1_PRE_FIELDS)
    pre.crc_32 = int(_BitReader(bits[168:200]).get(32))
    return pre


def parse_l1_post_info(bits: np.ndarray, pre: L1Pre) -> L1Post | None:
    """Parse l1_post_info_size+32 hard bits; None on CRC32 mismatch."""
    bits = np.asarray(bits, dtype=np.uint8)
    info = pre.l1_post_info_size
    if crc32(bits[:info]) != _BitReader(bits[info:info + 32]).get(32):
        return None
    r = _BitReader(bits)
    post = L1Post()
    r.get_fields(post, L1_POST_HEADER_FIELDS)
    post.rf = [L1PostRf() for _ in range(pre.num_rf)]
    for rf in post.rf:
        r.get_fields(rf, L1_POST_RF_FIELDS)
    if pre.s2_field2:
        r.get_fields(post, L1_POST_FEF_FIELDS)
    post.plp = [L1PostPlp() for _ in range(post.num_plp)]
    for plp in post.plp:
        r.get_fields(plp, L1_POST_PLP_FIELDS)
    r.get_fields(post, L1_POST_TRAILER_FIELDS)
    post.aux = [_Aux() for _ in range(post.num_aux)]
    for aux in post.aux:
        r.get_fields(aux, L1_POST_AUX_FIELDS)
    post.dyn = _parse_dyn(r, post.num_plp, post.num_aux)
    if pre.l1_repetition_flag:
        post.dyn_next = _parse_dyn(r, post.num_plp, post.num_aux)
    return post


@dataclasses.dataclass
class _Aux:
    aux_stream_type: int = 0
    aux_private_conf: int = 0


def _parse_dyn(r: _BitReader, num_plp: int, num_aux: int) -> L1Dyn:
    dyn = L1Dyn()
    r.get_fields(dyn, L1_DYN_FIELDS)
    dyn.plp = [L1DynPlp() for _ in range(num_plp)]
    for p in dyn.plp:
        r.get_fields(p, L1_DYN_PLP_FIELDS)
    dyn.reserved_3 = r.get(8)
    dyn.aux_private_dyn = [r.get(48) for _ in range(num_aux)]
    return dyn
