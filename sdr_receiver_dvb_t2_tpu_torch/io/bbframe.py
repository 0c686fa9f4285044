"""BB frames: TS packet encapsulation (TX) and de-encapsulation (RX).

ETSI EN 302 755 clause 5 (mode adaptation / stream adaptation): TS packets
are packed into baseband frames of K_bch bits.  Two input modes:

* Normal Mode (NM): the 0x47 sync byte of every packet is replaced by the
  CRC-8 of the *previous* packet's 187 payload bytes.
* High Efficiency Mode (HEM): the sync byte is simply removed.

The 80-bit BB header encodes MATYPE, UPL, DFL, SYNC and SYNCD; its 8-bit
MODE/CRC field is the CRC-8 of the first 72 bits, XORed with 0 for NM and
with the CRC-8 polynomial constant for HEM (detection logic mirrored from
reference/src/DVB_T2/bb_de_header.cpp:59-108).  The whole BB frame is
then scrambled with the BB PRBS.

The RX half reassembles 188-byte TS packets across BB frame boundaries,
checks per-packet CRC-8 in NM (setting the Transport Error Indicator on
mismatch) and resynchronizes via SYNCD after data loss — the same recovery
behaviour as bb_de_header.cpp:157-440.
"""
from __future__ import annotations

import dataclasses
import numpy as np

CRC8_POLY_REFLECTED = 0xAB        # bit-serial LSB-first form
CRC8_POLY = 0xD5                  # byte-table MSB-first form
TS_LEN = 188
HEADER_BITS = 80


def _crc8_table() -> np.ndarray:
    table = np.empty(256, dtype=np.uint8)
    for i in range(256):
        crc = 0
        r = i
        for j in range(7, -1, -1):
            if ((r >> j) & 1) ^ ((crc >> 7) & 1):
                crc = ((crc << 1) ^ CRC8_POLY) & 0xFF
            else:
                crc = (crc << 1) & 0xFF
        table[i] = crc
    return table


_CRC8_TABLE = _crc8_table()


def crc8_bytes(data: np.ndarray) -> int:
    """Table-driven CRC-8 over bytes (packet CRC in NM mode)."""
    crc = 0
    for b in np.asarray(data, dtype=np.uint8):
        crc = _CRC8_TABLE[int(b) ^ crc]
    return int(crc)


def crc8_bits(bits: np.ndarray) -> int:
    """Bit-serial CRC-8, LSB-first polynomial (header MODE detection)."""
    crc = 0
    for bit in np.asarray(bits, dtype=np.uint8):
        b = int(bit) ^ (crc & 1)
        crc >>= 1
        if b:
            crc ^= CRC8_POLY_REFLECTED
    return crc


def _bits_of_bytes(data: np.ndarray) -> np.ndarray:
    return np.unpackbits(np.asarray(data, dtype=np.uint8))


def _bytes_of_bits(bits: np.ndarray) -> np.ndarray:
    return np.packbits(np.asarray(bits, dtype=np.uint8))


def _mode_field(header72: np.ndarray, hem: bool) -> int:
    """Solve for the 8-bit field making crc8_bits(header80) == target."""
    target = CRC8_POLY_REFLECTED if hem else 0
    for cand in range(256):
        bits = np.concatenate([header72, np.unpackbits(np.uint8(cand))])
        if crc8_bits(bits) == target:
            return cand
    raise AssertionError("unreachable: CRC-8 is surjective")


@dataclasses.dataclass
class BBFramePacker:
    """Packs a TS byte stream into BB frames (single PLP, CCM).

    ``padding_hook(frame_index)`` (optional) returns a bit array to carry
    in that BB frame's padding field — the in-band signalling insertion
    point (EN 302 755 clause 5.2.3; see io/inband.py): the frame's DFL
    shrinks to leave room and the bits follow the data field.
    """
    k_bch: int
    hem: bool = True
    issyi: bool = False
    npd: bool = False
    issy_len: int = 3            # NM ISSY field bytes (2 short / 3 long)
    padding_hook: object = None

    def __post_init__(self):
        assert self.issy_len in (2, 3)
        self._pending = np.empty(0, dtype=np.uint8)   # unit-stream bytes
        self._offset_in_packet = 0                    # bytes already sent
        # EN 302 755 clause 5.1 mode adaptation order: input stream
        # synchronizer (appends ISSY to each UP) -> null-packet deletion
        # (appends DNP) -> CRC-8 encoder.  So the NM unit on the wire is
        # [CRC8][187][ISSY][DNP] and the CRC covers everything after the
        # CRC byte.  HEM carries no per-UP ISSY: the 3-byte value rides in
        # the header's UPL+SYNC fields instead (clause 5.2.2).
        self._issy_nm = self.issy_len if (self.issyi and not self.hem) else 0
        self._unit = (TS_LEN - 1 if self.hem else TS_LEN) \
            + self._issy_nm + (1 if self.npd else 0)
        self._last_crc = 0
        self._dnp = 0                                 # nulls deleted so far
        self._frame_counter = 0                       # BB frames built
        self._iscr = 0                # fixture ISCR: input-packet counter

    def _issy_bytes(self) -> np.ndarray:
        v = self._iscr & ((1 << (8 * self.issy_len)) - 1)
        return np.array([(v >> (8 * k)) & 0xFF
                         for k in range(self.issy_len - 1, -1, -1)],
                        dtype=np.uint8)

    def _push_packets(self, ts: np.ndarray):
        ts = np.asarray(ts, dtype=np.uint8).reshape(-1, TS_LEN)
        assert (ts[:, 0] == 0x47).all(), "TS packets must start with 0x47"
        units = []
        for pkt in ts:
            self._iscr += 1          # ISCR ticks per input packet
            if self.npd and pkt[1] == 0x1F and pkt[2] == 0xFF \
                    and self._dnp < 255:
                self._dnp += 1          # delete null packet, bump DNP count
                continue
            body = pkt[1:] if self.hem else pkt.copy()
            if self._issy_nm:
                body = np.concatenate([body, self._issy_bytes()])
            if self.npd:
                body = np.concatenate([body, [np.uint8(self._dnp)]])
                self._dnp = 0
            if not self.hem:
                # replace sync byte with the CRC-8 of the previous UP;
                # the CRC-8 encoder runs after ISSY/DNP insertion, so it
                # covers the whole UP after the CRC position
                crc = crc8_bytes(body[1:])
                body[0] = self._last_crc
                self._last_crc = crc
            units.append(body)
        if units:
            self._pending = np.concatenate([self._pending] + units)

    def pack(self, ts_stream: np.ndarray) -> list[np.ndarray]:
        """Feed TS bytes; returns list of K_bch-bit scrambled BB frames."""
        self._push_packets(ts_stream)
        frames = []
        max_dfl_bytes = (self.k_bch - HEADER_BITS) // 8
        while True:
            pad = (self.padding_hook(self._frame_counter)
                   if self.padding_hook is not None else None)
            dfl_bytes = max_dfl_bytes - (
                0 if pad is None else -(-len(pad) // 8))
            if len(self._pending) < dfl_bytes:
                break
            data = self._pending[:dfl_bytes]
            self._pending = self._pending[dfl_bytes:]
            to_boundary = (self._unit - self._offset_in_packet) % self._unit
            syncd = to_boundary * 8
            self._offset_in_packet = (self._offset_in_packet + dfl_bytes) % self._unit
            frames.append(self._build_frame(data, syncd, pad))
            self._frame_counter += 1
        return frames

    def _build_frame(self, data: np.ndarray, syncd: int,
                     padding_bits: np.ndarray | None = None) -> np.ndarray:
        bits = np.zeros(self.k_bch, dtype=np.uint8)
        hdr = np.zeros(72, dtype=np.uint8)
        # MATYPE-1: TS_GS=11, SIS_MIS=1(single), CCM_ACM=1(CCM), ISSYI, NPD, EXT=00
        matype1 = (0b11 << 6) | (1 << 5) | (1 << 4) | (int(self.issyi) << 3) \
            | (int(self.npd) << 2)
        hdr[0:8] = np.unpackbits(np.uint8(matype1))
        hdr[8:16] = 0                                    # MATYPE-2 / ISI
        if self.hem and self.issyi:
            # HEM reuses the UPL (2 bytes) + SYNC (1 byte) header fields to
            # carry the 3-byte ISSY of the frame (EN 302 755 clause 5.2.2)
            issy = self._iscr & 0xFFFFFF
            upl, sync = issy >> 8, issy & 0xFF
        else:
            upl = self._unit * 8 if not self.hem else 0
            sync = 0x47 if not self.hem else 0
        hdr[16:32] = np.unpackbits(np.array([upl >> 8, upl & 0xFF], dtype=np.uint8))
        dfl = len(data) * 8
        hdr[32:48] = np.unpackbits(np.array([dfl >> 8, dfl & 0xFF], dtype=np.uint8))
        hdr[48:56] = np.unpackbits(np.uint8(sync))
        hdr[56:72] = np.unpackbits(np.array([syncd >> 8, syncd & 0xFF], dtype=np.uint8))
        mode = _mode_field(hdr, self.hem)
        bits[:72] = hdr
        bits[72:80] = np.unpackbits(np.uint8(mode))
        bits[80:80 + dfl] = _bits_of_bytes(data)
        if padding_bits is not None:
            pad = np.asarray(padding_bits, dtype=np.uint8)
            bits[80 + dfl:80 + dfl + len(pad)] = pad
        from ..params import prbs
        return bits ^ prbs.bb_scrambler(self.k_bch)


TEI_FLAG = 0x80


@dataclasses.dataclass
class _PlpState:
    partial: np.ndarray = dataclasses.field(
        default_factory=lambda: np.empty(0, dtype=np.uint8))
    crc: int = -1                 # -1 = chain not established (NM mode)
    synced: bool = False


_NULL_PACKET = np.concatenate(
    [np.array([0x47, 0x1F, 0xFF, 0x10], np.uint8),
     np.full(TS_LEN - 4, 0xFF, np.uint8)])


class BBFrameParser:
    """Reassembles TS packets from descrambled BB frames (one PLP).

    MATYPE fields (TS_GS/SIS_MIS/CCM_ACM/ISSYI/NPD/ISI,
    bb_de_header.cpp:110-155) are parsed and exposed via ``matype``;
    NPD streams get their deleted null packets re-inserted from the DNP
    byte appended to each UP; ISSY timestamps are stripped and counted
    (pass-through — ``issy_stripped`` / ``last_issy``; the reference only
    displays the ISSYI flag and would mis-parse the stream,
    bb_de_header.cpp:501-503); non-TS streams and malformed ISSY lengths
    are rejected loudly (``unsupported`` counter) rather than silently
    desyncing.
    """

    def __init__(self):
        self.state = _PlpState()
        self.mode_hem: bool | None = None
        self.header_errors = 0
        self.crc_errors = 0
        self.unsupported = 0
        self.null_reinserted = 0
        self.truncated = 0
        self.issy_stripped = 0       # ISSY values consumed (UPs in NM,
        self.last_issy = -1          # frames in HEM) and the latest value
        self.matype: dict | None = None

    def parse(self, frame_bits: np.ndarray) -> np.ndarray:
        """Scrambled K_bch bits (one per byte) -> TS bytes."""
        return self.parse_bytes(_bytes_of_bits(frame_bits))

    def parse_batch(self, frames_bytes: np.ndarray) -> np.ndarray:
        out = [self.parse_bytes(f) for f in np.asarray(frames_bytes)]
        out = [o for o in out if len(o)]
        return (np.concatenate(out) if out else np.empty(0, np.uint8))

    def parse_bytes(self, frame_bytes: np.ndarray) -> np.ndarray:
        """One packed scrambled BB frame (k_bch/8 bytes) -> TS bytes."""
        from ..params import prbs
        raw = np.asarray(frame_bytes, dtype=np.uint8)
        by = raw ^ _bytes_of_bits(prbs.bb_scrambler(len(raw) * 8))
        hdr_bits = _bits_of_bytes(by[:HEADER_BITS // 8])
        check = crc8_bits(hdr_bits)
        if check == 0:
            hem = False
        elif check == CRC8_POLY_REFLECTED:
            hem = True
        else:
            self.header_errors += 1
            self.state.synced = False
            return np.empty(0, dtype=np.uint8)
        self.mode_hem = hem
        matype1 = int(by[0])
        self.matype = dict(
            ts_gs=matype1 >> 6, sis_mis=(matype1 >> 5) & 1,
            ccm_acm=(matype1 >> 4) & 1, issyi=(matype1 >> 3) & 1,
            npd=(matype1 >> 2) & 1,
            isi=-1 if (matype1 >> 5) & 1 else int(by[1]))
        if self.matype["ts_gs"] != 0b11:
            self.unsupported += 1
            self.state.synced = False
            return np.empty(0, dtype=np.uint8)
        npd = bool(self.matype["npd"])
        upl = int(by[2]) << 8 | int(by[3])
        issy_nm = 0
        if self.matype["issyi"]:
            if hem:
                # HEM: the 3-byte ISSY rides in the header's UPL+SYNC
                # fields (EN 302 755 clause 5.2.2) — data field unchanged
                self.last_issy = (int(by[2]) << 16) | (int(by[3]) << 8) \
                    | int(by[6])
                self.issy_stripped += 1
            else:
                # NM: a 2- or 3-byte ISSY is appended to each UP; UPL
                # tells which (some transmitters count the DNP byte in
                # UPL, some don't — accept either)
                cand = upl // 8 - TS_LEN - (1 if npd else 0)
                if cand not in (2, 3):
                    cand = upl // 8 - TS_LEN
                if cand not in (2, 3):
                    self.unsupported += 1       # malformed ISSY length
                    self.state.synced = False
                    return np.empty(0, dtype=np.uint8)
                issy_nm = cand
        dfl = int(by[4]) << 8 | int(by[5])
        syncd = int(by[7]) << 8 | int(by[8])
        if dfl <= 0 or HEADER_BITS + dfl > len(raw) * 8:
            return np.empty(0, dtype=np.uint8)
        data = by[HEADER_BITS // 8:HEADER_BITS // 8 + dfl // 8]
        unit = (TS_LEN - 1 if hem else TS_LEN) + issy_nm + (1 if npd else 0)
        st = self.state
        out = []
        if syncd == 65535:
            # continuation-only frame: no UP starts here; the whole data
            # field extends the in-flight packet (bb_de_header.cpp handles
            # this via SYNCD-less accumulation)
            if not st.synced:
                return np.empty(0, dtype=np.uint8)
        elif not st.synced:
            data = data[syncd // 8:]
            st.partial = np.empty(0, dtype=np.uint8)
            st.synced = True
            st.crc = -1                      # fresh sync: no CRC chain yet
        else:
            need = unit - len(st.partial)
            if syncd // 8 != need % unit and not (len(st.partial) == 0 and syncd // 8 == 0):
                # lost alignment: resynchronize at SYNCD
                self.crc_errors += 1
                data = data[syncd // 8:]
                st.partial = np.empty(0, dtype=np.uint8)
                st.crc = -1                  # CRC chain broken: re-arm
        stream = np.concatenate([st.partial, data])
        n_units = len(stream) // unit
        st.partial = stream[n_units * unit:]
        units = stream[:n_units * unit].reshape(-1, unit)
        payload_len = TS_LEN - 1 if hem else TS_LEN
        for u in units:
            if npd:
                # DNP byte appended to each UP (after any ISSY): deleted
                # null packets immediately before it (EN 302 755 5.1.5)
                dnp = int(u[-1])
                self.null_reinserted += dnp
                out.extend([_NULL_PACKET] * dnp)
            if issy_nm:
                self.last_issy = int.from_bytes(
                    bytes(u[payload_len:payload_len + issy_nm]), "big")
                self.issy_stripped += 1
            if hem:
                pkt = np.concatenate([[0x47], u[:payload_len]]) \
                    .astype(np.uint8)
            else:
                pkt = np.concatenate([[0x47], u[1:payload_len]]) \
                    .astype(np.uint8)
                # CRC of this UP arrives as the next UP's first byte; full
                # inter-packet checking requires lookahead, so we validate
                # against the embedded previous-CRC chain instead.  The
                # CRC-8 encoder runs after ISSY insertion and null
                # deletion (clause 5.1 figure), so the chain covers the
                # ISSY and DNP suffixes too.
                if st.crc >= 0 and st.crc != int(u[0]):
                    self.crc_errors += 1
                    pkt[1] |= TEI_FLAG
                st.crc = crc8_bytes(u[1:])
            out.append(pkt)
        if out:
            return np.concatenate(out)
        return np.empty(0, dtype=np.uint8)
