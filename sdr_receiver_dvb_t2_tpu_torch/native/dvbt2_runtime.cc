// Native runtime components: BB-frame de-encapsulation and IQ ring buffer.
//
// The reference implements its whole runtime in C++ (bb_de_header.cpp for
// the TS output path, rx_base.cpp + buffers.hh for ingest buffering); this
// library provides the receiver's equivalents for the host-side hot
// paths that stay off the accelerator:
//
//  * BbParser — descrambles BB frames, validates the header CRC-8, detects
//    NM/HEM, reassembles 188-byte TS packets across frame boundaries with
//    SYNCD resynchronization and NM per-packet CRC chains (TEI flagging),
//    mirroring reference/src/DVB_T2/bb_de_header.cpp:97-440.
//  * IqRing — single-producer single-consumer lock-free byte ring for the
//    ingest thread (socket/file reader) feeding the compute thread,
//    replacing the reference's mutex-guarded A/B double buffer
//    (reference/src/rx_base.h:44-51).
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 dependency).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kTsLen = 188;
constexpr int kHeaderBits = 80;
constexpr uint8_t kCrc8Poly = 0xD5;           // byte-table MSB-first
constexpr uint8_t kCrc8PolyReflected = 0xAB;  // bit-serial LSB-first
constexpr uint8_t kTeiFlag = 0x80;

struct Crc8Table {
  uint8_t t[256];
  Crc8Table() {
    for (int i = 0; i < 256; ++i) {
      uint8_t crc = 0;
      for (int j = 7; j >= 0; --j) {
        int b = ((i >> j) & 1) ^ ((crc >> 7) & 1);
        crc = static_cast<uint8_t>(crc << 1);
        if (b) crc ^= kCrc8Poly;
      }
      t[i] = crc;
    }
  }
};
const Crc8Table kCrcTable;

uint8_t crc8_bytes(const uint8_t* data, int n) {
  uint8_t crc = 0;
  for (int i = 0; i < n; ++i) crc = kCrcTable.t[data[i] ^ crc];
  return crc;
}

uint8_t crc8_bits(const uint8_t* bits, int n) {
  uint8_t crc = 0;
  for (int i = 0; i < n; ++i) {
    int b = (bits[i] & 1) ^ (crc & 1);
    crc >>= 1;
    if (b) crc ^= kCrc8PolyReflected;
  }
  return crc;
}

}  // namespace

// ---------------------------------------------------------------------------
// BB-frame parser
// ---------------------------------------------------------------------------

struct BbParser {
  std::vector<uint8_t> partial;
  std::vector<uint8_t> scrambler;        // cached PRBS bits
  std::vector<uint8_t> scrambler_bytes;  // cached PRBS packed to bytes
  std::vector<uint8_t> outbuf;           // retained output of the last parse
  int crc = -1;                     // -1 = NM CRC chain not established
  bool synced = false;
  int64_t header_errors = 0;
  int64_t crc_errors = 0;
  int64_t unsupported = 0;          // frames rejected (non-TS / bad ISSY len)
  int64_t truncated = 0;            // packets dropped: caller buffer full
  int64_t null_reinserted = 0;      // null packets restored from DNP counts
  int64_t issy_stripped = 0;        // ISSY values consumed (UPs in NM,
  int64_t last_issy = -1;           //   frames in HEM) and the latest value
  int hem = -1;
  // last parsed MATYPE (reported like bb_de_header.cpp:110-155,497-510)
  int ts_gs = -1, sis_mis = -1, ccm_acm = -1, issyi = -1, npd = -1, isi = -1;

  const uint8_t* prbs(int length) {
    if (static_cast<int>(scrambler.size()) < length) {
      scrambler.resize(length);
      uint32_t sr = 0x4A80;
      for (int i = 0; i < length; ++i) {
        uint32_t b = (sr ^ (sr >> 1)) & 1;
        scrambler[i] = static_cast<uint8_t>(b);
        sr >>= 1;
        if (b) sr |= 0x4000;
      }
    }
    return scrambler.data();
  }

  const uint8_t* prbs_bytes(int n_bytes) {
    if (static_cast<int>(scrambler_bytes.size()) < n_bytes) {
      const uint8_t* bits = prbs(n_bytes * 8);
      scrambler_bytes.resize(n_bytes);
      for (int i = 0; i < n_bytes; ++i) {
        uint8_t b = 0;
        for (int j = 0; j < 8; ++j)
          b = static_cast<uint8_t>((b << 1) | bits[8 * i + j]);
        scrambler_bytes[i] = b;
      }
    }
    return scrambler_bytes.data();
  }
};

namespace {

// 188-byte TS null packet (PID 0x1FFF), re-inserted for DNP counts.
void emit_null_packet(uint8_t* out) {
  out[0] = 0x47;
  out[1] = 0x1F;
  out[2] = 0xFF;
  out[3] = 0x10;
  std::memset(out + 4, 0xFF, kTsLen - 4);
}

}  // namespace

extern "C" {

BbParser* bb_parser_new() { return new BbParser(); }
void bb_parser_free(BbParser* p) { delete p; }
int64_t bb_parser_header_errors(const BbParser* p) { return p->header_errors; }
int64_t bb_parser_crc_errors(const BbParser* p) { return p->crc_errors; }
int64_t bb_parser_unsupported(const BbParser* p) { return p->unsupported; }
int64_t bb_parser_null_reinserted(const BbParser* p) {
  return p->null_reinserted;
}
int64_t bb_parser_issy_stripped(const BbParser* p) { return p->issy_stripped; }
int64_t bb_parser_last_issy(const BbParser* p) { return p->last_issy; }
int64_t bb_parser_truncated(const BbParser* p) { return p->truncated; }
int bb_parser_hem(const BbParser* p) { return p->hem; }
// Last parsed MATYPE, packed: ts_gs<<8 | sis_mis<<7 | ccm_acm<<6 |
// issyi<<5 | npd<<4 | (isi & 0xF... isi returned separately); -1 = none.
int bb_parser_matype(const BbParser* p) {
  if (p->ts_gs < 0) return -1;
  return (p->ts_gs << 8) | (p->sis_mis << 7) | (p->ccm_acm << 6) |
         (p->issyi << 5) | (p->npd << 4);
}
int bb_parser_isi(const BbParser* p) { return p->isi; }

namespace {

// Core parse of one frame, appending TS packets to p->outbuf (growable —
// NPD re-insertion can legally expand output ~256x, so no fixed caller
// buffer can bound it; the retained vector never drops packets).
// Returns appended TS bytes (multiple of 188), or -1 on header CRC failure.
// MATYPE handling (parity+: reference only displays these fields,
// bb_de_header.cpp:110-155,497-510): TS_GS/SIS_MIS/CCM_ACM/ISSYI/NPD/ISI
// are parsed and exposed via accessors; NPD streams have their deleted
// null packets re-inserted from the per-UP DNP count; ISSY timestamps are
// stripped and counted (pass-through — NM appends 2-3 bytes per UP with
// UPL giving the length, HEM carries a 3-byte value in the header's
// UPL+SYNC fields, EN 302 755 clauses 5.1.8/5.2.2); non-TS streams and
// malformed ISSY lengths are rejected loudly (unsupported counter).
int64_t parse_frame_into(BbParser* p, const uint8_t* frame, int n_bytes) {
  std::vector<uint8_t> data_buf(n_bytes);
  const uint8_t* sc = p->prbs_bytes(n_bytes);
  for (int i = 0; i < n_bytes; ++i) data_buf[i] = frame[i] ^ sc[i];
  const uint8_t* b = data_buf.data();

  // header CRC-8 runs bit-serial over the 80 header bits
  uint8_t hdr_bits[kHeaderBits];
  for (int i = 0; i < kHeaderBits; ++i)
    hdr_bits[i] = (b[i / 8] >> (7 - i % 8)) & 1;
  uint8_t check = crc8_bits(hdr_bits, kHeaderBits);
  bool hem;
  if (check == 0) {
    hem = false;
  } else if (check == kCrc8PolyReflected) {
    hem = true;
  } else {
    p->header_errors++;
    p->synced = false;
    return -1;
  }
  p->hem = hem ? 1 : 0;

  uint8_t matype1 = b[0];
  p->ts_gs = matype1 >> 6;
  p->sis_mis = (matype1 >> 5) & 1;
  p->ccm_acm = (matype1 >> 4) & 1;
  p->issyi = (matype1 >> 3) & 1;
  p->npd = (matype1 >> 2) & 1;
  p->isi = p->sis_mis ? -1 : b[1];  // MATYPE-2 carries ISI when MIS
  if (p->ts_gs != 0b11) {
    // generic streams are not consumed by this TS output path — reject
    // the frame loudly instead of desyncing
    p->unsupported++;
    p->synced = false;
    return 0;
  }
  int upl = (b[2] << 8) | b[3];
  int issy_nm = 0;  // per-UP ISSY bytes in the data field (NM only)
  if (p->issyi) {
    if (hem) {
      // HEM: the 3-byte ISSY rides in the header's UPL+SYNC fields
      // (EN 302 755 clause 5.2.2) — the data field is unchanged
      p->last_issy = (static_cast<int64_t>(b[2]) << 16) | (b[3] << 8) | b[6];
      p->issy_stripped++;
    } else {
      // NM: 2- or 3-byte ISSY appended to each UP; UPL gives the length
      // (some transmitters count the DNP byte in UPL, some don't)
      int cand = upl / 8 - kTsLen - (p->npd ? 1 : 0);
      if (cand != 2 && cand != 3) cand = upl / 8 - kTsLen;
      if (cand != 2 && cand != 3) {
        p->unsupported++;  // malformed ISSY length
        p->synced = false;
        return 0;
      }
      issy_nm = cand;
    }
  }

  int dfl = (b[4] << 8) | b[5];
  int syncd = (b[7] << 8) | b[8];
  if (dfl <= 0 || kHeaderBits + dfl > n_bytes * 8) return 0;

  // UP length in the data field: TS payload (+ISSY in NM, +1 DNP when NPD)
  int unit = (hem ? kTsLen - 1 : kTsLen) + issy_nm + (p->npd ? 1 : 0);
  const uint8_t* d = b + kHeaderBits / 8;
  int n = dfl / 8;
  if (syncd == 0xFFFF) {
    // continuation-only frame: everything extends the in-flight packet
    if (!p->synced) return 0;
  } else if (!p->synced) {
    int skip = syncd / 8;
    if (skip > n) return 0;
    d += skip;
    n -= skip;
    p->partial.clear();
    p->synced = true;
    p->crc = -1;                   // fresh sync: no CRC chain yet
  } else {
    int need = (unit - static_cast<int>(p->partial.size())) % unit;
    int skip = syncd / 8;
    bool aligned = (skip == need) ||
                   (p->partial.empty() && skip == 0);
    if (!aligned) {
      p->crc_errors++;
      if (skip > n) return 0;
      d += skip;
      n -= skip;
      p->partial.clear();
      p->crc = -1;                 // CRC chain broken: re-arm
    }
  }

  std::vector<uint8_t> stream;
  stream.reserve(p->partial.size() + n);
  stream.insert(stream.end(), p->partial.begin(), p->partial.end());
  stream.insert(stream.end(), d, d + n);
  int n_units = static_cast<int>(stream.size()) / unit;
  p->partial.assign(stream.begin() + n_units * unit, stream.end());

  int payload = hem ? kTsLen - 1 : kTsLen;   // bytes before any DNP suffix
  int64_t written = 0;
  std::vector<uint8_t>& ob = p->outbuf;
  for (int u = 0; u < n_units; ++u) {
    const uint8_t* up = stream.data() + u * unit;
    if (p->npd) {
      // DNP byte appended to each UP (after any ISSY) counts the null
      // packets deleted immediately before it (EN 302 755 clause 5.1.5)
      int dnp = up[unit - 1];
      p->null_reinserted += dnp;
      for (int z = 0; z < dnp; ++z) {
        ob.resize(ob.size() + kTsLen);
        emit_null_packet(ob.data() + ob.size() - kTsLen);
        written += kTsLen;
      }
    }
    if (issy_nm) {
      int64_t v = 0;
      for (int k = 0; k < issy_nm; ++k) v = (v << 8) | up[payload + k];
      p->last_issy = v;
      p->issy_stripped++;
    }
    size_t at = ob.size();
    ob.resize(at + kTsLen);
    ob[at] = 0x47;
    if (hem) {
      std::memcpy(ob.data() + at + 1, up, payload);
    } else {
      std::memcpy(ob.data() + at + 1, up + 1, payload - 1);
      // the CRC-8 encoder runs after ISSY insertion and null deletion
      // (clause 5.1 figure), so the chain covers ISSY/DNP suffixes too
      if (p->crc >= 0 && p->crc != up[0]) {
        p->crc_errors++;
        ob[at + 1] |= kTeiFlag;
      }
      p->crc = crc8_bytes(up + 1, unit - 1);
    }
    written += kTsLen;
  }
  return written;
}

}  // namespace

// Copy-out of the retained output from the last parse call: whole TS
// packets only; anything beyond out_cap stays retained (re-fetch with a
// larger buffer via bb_parser_copy_out — nothing is ever dropped by the
// parser itself).  Returns bytes copied.
int64_t bb_parser_copy_out(BbParser* p, uint8_t* out, int64_t out_cap) {
  int64_t n = static_cast<int64_t>(p->outbuf.size());
  if (n > out_cap) n = out_cap - out_cap % kTsLen;
  if (n < 0) n = 0;
  std::memcpy(out, p->outbuf.data(), n);
  return n;
}

// Total TS bytes retained from the last parse (may exceed the cap the
// caller passed; compare and re-fetch with bb_parser_copy_out).
int64_t bb_parser_out_size(const BbParser* p) {
  return static_cast<int64_t>(p->outbuf.size());
}

// frame: k_bch/8 scrambled BB-frame BYTES (MSB-first bit packing — exactly
// what the device-side pack_bits_t transfer produces).
// Parses into the retained buffer, copies up to out_cap whole packets into
// `out`, and returns the TOTAL bytes produced (which can exceed out_cap —
// NPD re-insertion expands up to ~256x; callers must then re-fetch via
// bb_parser_copy_out).  Returns -1 on header CRC failure.
int bb_parser_parse_bytes(BbParser* p, const uint8_t* frame, int n_bytes,
                          uint8_t* out, int64_t out_cap) {
  p->outbuf.clear();
  int64_t n = parse_frame_into(p, frame, n_bytes);
  if (n < 0) return -1;
  bb_parser_copy_out(p, out, out_cap);
  return static_cast<int>(n);
}

// Batched packed-bytes parse: n_frames rows of bytes_each scrambled
// BB-frame bytes.  Header-CRC failures are skipped (counters advance).
// Parses everything into the retained buffer, copies up to out_cap whole
// packets, and returns the TOTAL bytes produced (re-fetch the remainder
// with bb_parser_copy_out when it exceeds out_cap).
int64_t bb_parser_parse_batch(BbParser* p, const uint8_t* frames,
                              int n_frames, int bytes_each, uint8_t* out,
                              int64_t out_cap) {
  p->outbuf.clear();
  for (int f = 0; f < n_frames; ++f)
    parse_frame_into(p, frames + static_cast<int64_t>(f) * bytes_each,
                     bytes_each);
  bb_parser_copy_out(p, out, out_cap);
  return static_cast<int64_t>(p->outbuf.size());
}

// Legacy bit-array interface (one byte per bit) — packs and delegates.
// Fixed caller-buffer contract (k_bch/8 + 188 bytes): output beyond it is
// dropped here, counted per dropped packet in the `truncated` stat.
int bb_parser_parse(BbParser* p, const uint8_t* frame_bits, int k_bch,
                    uint8_t* out) {
  std::vector<uint8_t> bytes(k_bch / 8);
  for (int i = 0; i < static_cast<int>(bytes.size()); ++i) {
    uint8_t v = 0;
    for (int j = 0; j < 8; ++j)
      v = static_cast<uint8_t>((v << 1) | (frame_bits[8 * i + j] & 1));
    bytes[i] = v;
  }
  int64_t cap = k_bch / 8 + kTsLen;
  int total = bb_parser_parse_bytes(p, bytes.data(),
                                    static_cast<int>(bytes.size()), out, cap);
  if (total <= 0) return total;
  int64_t copied = cap - cap % kTsLen;
  if (total <= copied) return total;
  p->truncated += (total - copied) / kTsLen;
  return static_cast<int>(copied);
}

uint8_t dvbt2_crc8_bytes(const uint8_t* data, int n) {
  return crc8_bytes(data, n);
}
uint8_t dvbt2_crc8_bits(const uint8_t* bits, int n) {
  return crc8_bits(bits, n);
}

// ---------------------------------------------------------------------------
// SPSC lock-free ring buffer (ingest thread -> compute thread)
// ---------------------------------------------------------------------------

struct IqRing {
  std::vector<uint8_t> buf;
  size_t cap;
  std::atomic<uint64_t> head{0};   // written by producer
  std::atomic<uint64_t> tail{0};   // written by consumer
  std::atomic<uint64_t> dropped{0};
  explicit IqRing(size_t capacity) : buf(capacity), cap(capacity) {}
};

IqRing* iq_ring_new(uint64_t capacity) { return new IqRing(capacity); }
void iq_ring_free(IqRing* r) { delete r; }
uint64_t iq_ring_dropped(const IqRing* r) {
  return r->dropped.load(std::memory_order_relaxed);
}
uint64_t iq_ring_fill(const IqRing* r) {
  return r->head.load(std::memory_order_acquire) -
         r->tail.load(std::memory_order_acquire);
}

// Producer: copies n bytes in; drops the block if the ring is full
// (matching the reference's overrun policy, rx_base.cpp:185-198).
// Returns 1 on success, 0 if dropped.
int iq_ring_push(IqRing* r, const uint8_t* src, uint64_t n) {
  uint64_t head = r->head.load(std::memory_order_relaxed);
  uint64_t tail = r->tail.load(std::memory_order_acquire);
  if (head - tail + n > r->cap) {
    r->dropped.fetch_add(n, std::memory_order_relaxed);
    return 0;
  }
  uint64_t pos = head % r->cap;
  uint64_t first = std::min(n, r->cap - pos);
  std::memcpy(r->buf.data() + pos, src, first);
  std::memcpy(r->buf.data(), src + first, n - first);
  r->head.store(head + n, std::memory_order_release);
  return 1;
}

// Consumer: copies up to n bytes out; returns the number copied.
uint64_t iq_ring_pop(IqRing* r, uint8_t* dst, uint64_t n) {
  uint64_t head = r->head.load(std::memory_order_acquire);
  uint64_t tail = r->tail.load(std::memory_order_relaxed);
  uint64_t avail = head - tail;
  if (n > avail) n = avail;
  uint64_t pos = tail % r->cap;
  uint64_t first = std::min(n, r->cap - pos);
  std::memcpy(dst, r->buf.data() + pos, first);
  std::memcpy(dst + first, r->buf.data(), n - first);
  r->tail.store(tail + n, std::memory_order_release);
  return n;
}

}  // extern "C"
