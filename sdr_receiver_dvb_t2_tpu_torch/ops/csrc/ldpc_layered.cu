// Layered offset-min-sum LDPC decoder for the DVB-T2 QC-IRA codes, and the
// BCH syndrome screen of its hard bits.  CUDA C++ for Hopper (sm_90a).
//
// Replaces the TPU kernel sdr_receiver_dvb_t2_tpu/ops/ldpc_pallas.py:169
// (make_pallas_decoder -> kernel, pallas_call at :420) with its fused BCH
// epilogue (:369-382) and computes what they compute, the early exit
// included (see "Tile exit" below and ops/ldpc.py).
//
// What bounds it.  The function's own bytes are small (64,800 LLR bytes in
// and 5,400 BB-frame bytes out per NORMAL codeword, ~0.03 ms for 1616
// codewords at 3.35 TB/s).  Its work is 32-bit integer operations, about 34
// instructions per edge and sweep as compiled, most of them compares,
// selects and min/max, which the SM executes at 64 lanes a clock (half its
// float rate), in a chain of check rows that must run in order.  The
// kernel runs at that integer rate (PERF.md), so the design keeps
// everything a sweep touches on the chip and spends as few instructions
// and barriers per row as it can:
//  * one thread block a codeword at a time (the grid is persistent: "Tile
//    exit"), 384 threads; thread m < 360 owns check m of every check row
//    (the 360 checks of a row are independent, and each slot's cyclic
//    shift makes its access a permutation of the group);
//  * posteriors (n bytes, int8: every posterior is an integer clipped to
//    +-127) live in shared memory, loaded as 16-byte vectors; with the row
//    tables that is 69 KB for NORMAL r2/3, three blocks an SM;
//  * the check-to-variable messages are not stored.  Per check one word
//    holds min(m1, 32), min(m2, 32), the argmin slot and one sign bit per
//    slot (ops/ldpc.py compress_row; 32 bits up to cnl = 13, else 64; the
//    two parity slots sit behind the kernel's unrolled slot count, which
//    is cnl or the next size up), and the old messages are expanded from
//    it.  Thread m is the only reader and writer of lane m's words, so they
//    are a per-thread array in local memory: coalesced by construction,
//    served from L1/L2 (240 B a thread for NORMAL r2/3), no barrier, no
//    tensor in device memory; the next row's word is loaded a row ahead.
//    (The same words in shared memory, 156.6 KB and one block an SM, ran
//    the flagship load some 15% slower: PERF.md);
//  * the per-row tables sit in shared memory, one 8-byte entry per slot;
//  * min1/min2/argmin run on keys (|t| * 32 + slot), three min/max per
//    slot; the offset and the cap are applied once per row (both are
//    monotone, and a tie at offset magnitude 0 gives zero messages whatever
//    the argmin); the signs of a row's t are shifted into one word, whose
//    parity then flips them all at once into the signs of the messages;
//  * a slot's posterior is read and written by the same thread, so pass 2
//    follows pass 1 without a barrier; only rows with a repeated group meet
//    (once before the first write, once before each repeat), and between
//    rows the block meets only where the row shares a group with a row
//    since the last meeting (ops/ldpc.py _row_info): 63 barriers a sweep
//    for NORMAL r2/3 where one per pass and repeat would be 240;
//  * the epilogue writes the hard bits once, as the BB frame's bytes (MSB
//    first, np.packbits order) in rows padded to 16 bytes: the host needs
//    those bytes, and the screen reads them as they are.
//
// Tile exit.  Pallas leaves its sweep loop when every codeword of its
// 128-codeword tile is clean in the same sweep; until then the clean ones
// sweep on, and that can change their bits (a sweep with no unsatisfied
// check can end on bits that are no codeword, and a clean codeword can
// relapse).  The tiles count from the start of each segment (one segment
// per Pallas call the call stands for); the host passes their first
// codewords, then W (ops/ldpc.py tile_starts).  One launch keeps that
// contract, with a tile's codewords sweeping in lockstep:
//  * the grid is persistent: G = min(W, resident capacity) blocks, the
//    capacity being what the occupancy calculator gives for the template
//    and its shared memory times the SMs, launched cooperatively, so
//    that all G blocks are resident or the launch fails and nothing runs;
//  * a block takes its codeword by a ticket (atomicAdd on a counter, so
//    in codeword order) and takes the next one when its tile stops;
//  * after each sweep but the last, thread 0 adds 1 + (dirty << 16) to
//    the word of (tile, sweep) and polls it until its low half counts the
//    tile's codewords; the high half is then the tile's dirty codewords,
//    and if it is 0 every codeword of the tile stops and writes the
//    outputs of that sweep.  The word carries all that is shared, so the
//    add and the poll need no fence; the counters are zeroed on the
//    call's stream before the launch.  (Two variants that keep the
//    contract, a dirty codeword sweeping on without waiting and the last
//    codewords spread over the SMs, each won on some loads and lost on
//    others on the H100: tools/ldpc_tile_barrier.py, PERF.md.)
// Nothing is decoded twice, and a codeword that relapses needs no case of
// its own: its tile simply does not stop in that sweep.
//
// Deadlock freedom, whatever the load, W, segments or table, given G >=
// min(W, 128), the largest tile (else the entry point refuses the call).
// A block waits only at a barrier of the tile it holds, and only for that
// tile's codewords to reach it.  Take the first tile T that has not
// stopped.  If all its codewords are held, every holder runs its sweeps
// and reaches each of T's barriers (a block holds one codeword at a time,
// and the tiles before T hold none), so T stops.  Else let c be the
// first codeword of T not taken: tickets go in order, so no block holds a
// codeword after c and none has run out of tickets; every block that
// holds a codeword holds one of T's before c, fewer than 128 <= G of
// them, so some resident block holds none and takes c next.  Either way
// T moves on, and by induction every tile stops.
//
// The BCH screen.  Syndrome bit (w, r) is the parity of popc(bytes[w] &
// h[r]) over the row's 32-bit words; bit order inside a word does not
// matter as long as H is packed in the same (ops/ldpc.py pack_bch_h).  On
// the ALU that is one LOP3 (acc ^= a & h) a word pair, some 0.024 ms for
// the flagship batch at 64 lanes a clock; the tensor cores' 1-bit product
// (mma m16n8k256 .and.popc, which ptxas takes for sm_90a) sums 256 such
// pairs of 16 codewords by 8 rows in one instruction, so the screen is
// bound by moving its operands instead (PERF.md).  A block holds a tile of
// 64 codewords by 32 syndrome rows; the two operands' word chunks come to
// shared memory by cp.async (16 bytes a copy, two stages); the words of a
// row are split over gridDim.z blocks so that the card is full (their
// parities meet by atomicXor; the tile's last block writes the flags).
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

namespace {

constexpr int M = 360;
constexpr int THREADS = 384;
constexpr int NWARPS = THREADS / 32;
constexpr int CLAMP = 56;
constexpr unsigned KEY_NONE = 0x7fffffffu;  // key of a slot with no message
constexpr int TILE = 128;  // codewords of a Pallas tile
constexpr unsigned DIRTY = 1u << 16;  // a dirty codeword in a barrier word
// the screen's tiles (its kernel below); the decoder zeroes the screen's
// scratch, one SYN_WORDS row a codeword, one count a tile
constexpr int SCR_TW = 64;     // codewords per screen block
constexpr int SCR_TR = 32;     // syndrome rows per screen block
constexpr int SYN_WORDS = 8;   // room for 256 syndrome rows

template <bool WIDE> struct StateWord { using type = uint32_t; };
template <> struct StateWord<true> { using type = unsigned long long; };
// most check rows of a table with a 32-bit word (NORMAL r1/2: 90) and with
// a 64-bit word (NORMAL r4/5: 36)
constexpr int MAXQ_NARROW = 90, MAXQ_WIDE = 36;

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum over the block; every thread gets the total.
__device__ __forceinline__ int block_sum(int v, int* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int w = 0; w < NWARPS; ++w) total += red[w];
  __syncthreads();
  return total;
}

// The tile barrier of one sweep (see "Tile exit"): true when none of the
// tile's `members` codewords is dirty in it.  Every thread of the block
// calls it with the same `dirty`; `flag` is shared.
__device__ __forceinline__ bool tile_clean(unsigned* word, bool dirty,
                                           int members, int* flag) {
  if (members == 1) return !dirty;
  if (threadIdx.x == 0) {
    const unsigned add = dirty ? 1u + DIRTY : 1u;
    unsigned v = atomicAdd(word, add) + add;
    while ((int)(v & (DIRTY - 1)) != members) {
      __nanosleep(200);
      asm volatile("ld.relaxed.gpu.u32 %0, [%1];" : "=r"(v) : "l"(word)
                   : "memory");
    }
    *flag = v < DIRTY;
  }
  __syncthreads();
  return *flag;
}

// The MSB-first byte of eight hard bits: the sign bits of the posteriors
// lo (bytes 0-3) and hi (bytes 4-7); the first posterior is the MSB.
__device__ __forceinline__ unsigned msb_byte(unsigned lo, unsigned hi) {
  // sign bits at 0, 8, 16, 24; the product gathers them, first one highest,
  // at bits 24-27 (no two partial products meet, so nothing carries)
  const unsigned a = (((lo >> 7) & 0x01010101u) * 0x08040201u) >> 24;
  const unsigned b = (((hi >> 7) & 0x01010101u) * 0x08040201u) >> 24;
  return a << 4 | b;
}

// clip(a + b, -127, 127); the add and the first clip are one instruction
__device__ __forceinline__ int add_clip127(int a, int b) {
  return min(__viaddmax_s32(a, b, -127), 127);
}

__device__ __forceinline__ unsigned clamp4(unsigned v) {
  return __vmins4(__vmaxs4(v, 0xC8C8C8C8u), 0x38383838u);  // +-56 per byte
}

// The messages of one check, as the state word holds them: a slot's message
// is -c (sign bit set) or min(c, 31), with c = c2 in the argmin slot and c1
// elsewhere.  c <= 32, so this is clip(+-m, -32, 31) of the uncapped m.
struct Messages {
  int p1, n1, p2, n2, idx;
  __device__ __forceinline__ Messages(int c1, int c2, int idx_)
      : p1(min(c1, 31)), n1(-c1), p2(min(c2, 31)), n2(-c2), idx(idx_) {}
  // The message of `slot`, its sign bit being `mask` of `w`.  Written in
  // PTX so that the test stays one and-with-predicate and the argmin slot
  // one predicated select, four instructions a message; from C the
  // compiler makes a shift, an and and a compare of the bit test.
  __device__ __forceinline__ int operator()(int slot, unsigned w,
                                            unsigned mask) const {
    int r;
    asm("{\n\t"
        ".reg .pred p, q;\n\t"
        ".reg .b32 t;\n\t"
        "and.b32 t, %1, %2;\n\t"
        "setp.ne.u32 p, t, 0;\n\t"
        "setp.eq.s32 q, %3, %4;\n\t"
        "selp.s32 %0, %5, %6, p;\n\t"
        "@q selp.s32 %0, %7, %8, p;\n\t"
        "}"
        : "=&r"(r)
        : "r"(w), "r"(mask), "r"(idx), "r"(slot), "r"(n1), "r"(p1), "r"(n2),
          "r"(p2));
    return r;
  }
};

__device__ __forceinline__ void take_min(int t, int slot, unsigned& k1,
                                         unsigned& k2) {
  const unsigned key = (unsigned)abs(t) * 32u + (unsigned)slot;
  k2 = min(k2, max(k1, key));
  k1 = min(k1, key);
}

// What one call hands the decoder kernel (see ldpc_layered_decode).
struct Params {
  const int8_t* llr;
  uint32_t* packed;
  int packed_words;
  int8_t* ok;
  int32_t* iters;
  uint32_t* syn;      // the screen's scratch, or null without a screen
  uint32_t* done;
  unsigned* ticket;   // the next codeword to take
  unsigned* barrier;  // one word a (tile, sweep but the last)
  const int32_t* tiles;  // [n_tiles + 1] first codewords, then W
  int n_tiles;
  const int2* slot_tab;
  const int32_t* row_tab;
  int W, k, q, cnl, max_iters;
};

// MAXC: unrolled data slots.  UNIFORM: every row has cnl data slots and the
// syndrome comes from the post-update signs (else from the pre-update signs
// of the slots a row has).  FULL: cnl == MAXC, so no slot is predicated.
template <int MAXC, bool UNIFORM, bool FULL>
__global__ void __launch_bounds__(THREADS, MAXC <= 9 ? 3 : 2)
ldpc_layered_kernel(const Params p) {
  constexpr bool WIDE = MAXC > 13;
  using Word = typename StateWord<WIDE>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int red[NWARPS];
  __shared__ int taken, clean_flag;
  const int k = p.k, q = p.q, max_iters = p.max_iters;
  const int cnl = FULL ? MAXC : p.cnl;
  const int n = k + q * M;
  const int n16 = (n + 15) & ~15;
  int8_t* lam = reinterpret_cast<int8_t*>(smem);  // [k] data, then [q*M] parity
  int8_t* par = lam + k;
  // this lane's word of every row: a per-thread array in local memory
  Word state[WIDE ? MAXQ_WIDE : MAXQ_NARROW];
  int2* stab = reinterpret_cast<int2*>(smem + n16);
  int32_t* rtab = reinterpret_cast<int32_t*>(stab + q * cnl);

  const int tid = threadIdx.x;
  const int m = tid;  // check lane
  const bool active = m < M;

  // row tables, once a block
  for (int j = tid; j < q * cnl; j += THREADS) stab[j] = p.slot_tab[j];
  for (int j = tid; j < q; j += THREADS) rtab[j] = p.row_tab[j];

  for (;;) {  // one codeword a round, taken by ticket (see "Tile exit")
    __syncthreads();  // the last round has read `taken` and the posteriors
    if (tid == 0) taken = (int)atomicAdd(p.ticket, 1u);
    __syncthreads();
    const int cw = taken;
    if (cw >= p.W) return;
    // its tile: the last one starting at or before cw
    int tile = 0, past = p.n_tiles;
    while (past - tile > 1) {
      const int mid = (tile + past) >> 1;
      if (p.tiles[mid] <= cw) tile = mid; else past = mid;
    }
    const int members = p.tiles[tile + 1] - p.tiles[tile];
    unsigned* bar = p.barrier + (size_t)tile * (max_iters - 1);

    // the channel LLRs clamped below the weakest bit's correction capacity
    const int8_t* llr_cw = p.llr + (size_t)cw * n;
    if ((n & 15) == 0 && (reinterpret_cast<uintptr_t>(llr_cw) & 15) == 0) {
      const uint4* s4 = reinterpret_cast<const uint4*>(llr_cw);
      uint4* d4 = reinterpret_cast<uint4*>(lam);
      for (int j = tid; j < n / 16; j += THREADS) {
        uint4 v = __ldg(s4 + j);
        v.x = clamp4(v.x);
        v.y = clamp4(v.y);
        v.z = clamp4(v.z);
        v.w = clamp4(v.w);
        d4[j] = v;
      }
    } else {
      for (int j = tid; j < n; j += THREADS)
        lam[j] = (int8_t)min(max((int)llr_cw[j], -CLAMP), CLAMP);
    }
    __syncthreads();

    int unsat = 0, first = 0;
    Word wnext = 0;
    for (int it = 0; it < max_iters; ++it) {
      int my_unsat = 0;
      for (int i = 0; i < q; ++i) {
        const int info = rtab[i];
        const int cnt_i = FULL ? MAXC : (info & 0xff);
        const int nfirst = (info >> 8) & 0xff;
        if (info >> 16) __syncthreads();
        const int2* erow = stab + i * cnl;
        const int ip = i > 0 ? i - 1 : q - 1;
        const int pm = i > 0 ? m : m - 1;  // check (row 0, lane 0) has none
        const bool valid_prev = active && pm >= 0;
        int t[MAXC], src[MAXC];
        int t_self = 0, t_prev = 0;
        int synacc = 0;    // syndrome parity, in the sign bit
        unsigned tsg = 0;  // sign of every slot's t, shifted in slot by slot
        unsigned k1 = KEY_NONE, k2 = KEY_NONE;

        // the row's old messages come from the word written a sweep ago
        // (all zero in the first sweep); the next row's word is asked for now
        const Word word = it == 0 ? (Word)0 : wnext;
        wnext = state[i + 1 < q ? i + 1 : 0];
        const unsigned lo = (unsigned)word;
        const Messages old(lo & 63, (lo >> 6) & 63, (lo >> 12) & 31);
        // sign bits: data slot j at 17 + j, then the two parity slots
#define OLD_MSG(slot)                                     \
    old((slot), (unsigned)(word >> ((17 + (slot)) & 32)), \
        1u << ((17 + (slot)) & 31))

        // ---------------- pass 1: gather, mins, signs ----------------
        if (active) {
#pragma unroll
          for (int slot = 0; slot < MAXC; ++slot) {
            int tt = 0;
            if (FULL || slot < cnt_i) {
              const int2 e = erow[slot];  // (group base, shift)
              // lane m - shift, wrapped: the smaller of the two as unsigned
              const unsigned back = (unsigned)(m - e.y);
              const int a = e.x + (int)__viaddmin_u32(back, (unsigned)M, back);
              src[slot] = a;
              const int slab = lam[a];
              tt = slab - OLD_MSG(slot);
              if (!UNIFORM) synacc ^= slab;
              take_min(tt, slot, k1, k2);
            }
            t[slot] = tt;
            tsg = __funnelshift_l((unsigned)tt, tsg, 1);
          }
          const int p_self = par[i * M + m];
          t_self = p_self - OLD_MSG(MAXC);
          if (!UNIFORM) synacc ^= p_self;
          tsg = __funnelshift_l((unsigned)t_self, tsg, 1);
          take_min(t_self, MAXC, k1, k2);
          if (valid_prev) {
            const int p_prev = par[ip * M + pm];
            t_prev = p_prev - OLD_MSG(MAXC + 1);
            if (!UNIFORM) synacc ^= p_prev;
            take_min(t_prev, MAXC + 1, k1, k2);
          }
          tsg = __funnelshift_l((unsigned)t_prev, tsg, 1);
        }
        // offset (beta = 1) and cap, once per row
        const int c1 = min(max((int)(k1 >> 5) - 1, 0), 32);
        const int c2 = min(max((int)(k2 >> 5) - 1, 0), 32);
        const Messages out(c1, c2, k1 & 31);
        // a slot's message has the sign of its t times the row's sign parity
        const unsigned tsr = __brev(tsg) >> (32 - (MAXC + 2));  // slot j, bit j
        const unsigned carry = (FULL ? (1u << MAXC) - 1u : (1u << cnt_i) - 1u) |
                               1u << MAXC | (unsigned)valid_prev << (MAXC + 1);
        const unsigned signs = (__popc(tsr) & 1) ? tsr ^ carry : tsr;
#define NEW_MSG(slot) out((slot), signs, 1u << (slot))

        // ---------------- pass 2: emit messages, update -------------
        // A first occurrence reads and writes its posterior in one thread:
        // lam + msg - old = t + msg.  Rows with a repeated group meet before
        // the first write and before each repeat's read-modify-write.
        const bool repeats = nfirst < cnt_i;
        if (repeats) __syncthreads();
        if (active) {
          if (FULL && !repeats) {  // most rows: every slot, no predicate
#pragma unroll
            for (int slot = 0; slot < MAXC; ++slot) {
              const int upd = add_clip127(t[slot], NEW_MSG(slot));
              lam[src[slot]] = (int8_t)upd;
              if (UNIFORM) synacc ^= upd;
            }
          } else {
#pragma unroll
            for (int slot = 0; slot < MAXC; ++slot) {
              if (slot < nfirst) {
                const int upd = add_clip127(t[slot], NEW_MSG(slot));
                lam[src[slot]] = (int8_t)upd;
                if (UNIFORM) synacc ^= upd;
              }
            }
          }
        }
        if (repeats) {
#pragma unroll
          for (int slot = 1; slot < MAXC; ++slot) {
            if (slot >= nfirst && slot < cnt_i) {
              __syncthreads();
              if (active) {
                const int upd = add_clip127(
                    (int)lam[src[slot]] - OLD_MSG(slot), NEW_MSG(slot));
                lam[src[slot]] = (int8_t)upd;
                if (UNIFORM) synacc ^= upd;
              }
            }
          }
        }
        if (active) {
          const int upd_self = add_clip127(t_self, NEW_MSG(MAXC));
          par[i * M + m] = (int8_t)upd_self;
          if (UNIFORM) synacc ^= upd_self;
          if (valid_prev) {
            const int upd_prev = add_clip127(t_prev, NEW_MSG(MAXC + 1));
            par[ip * M + pm] = (int8_t)upd_prev;
            if (UNIFORM) synacc ^= upd_prev;
          }
          state[i] = (Word)(c1 | (c2 << 6) | ((k1 & 31) << 12)) |
                     (Word)signs << 17;
          my_unsat += (unsigned)synacc >> 31;
        }
#undef NEW_MSG
#undef OLD_MSG
      }
      unsat = block_sum(my_unsat, red);
      if (unsat == 0 && first == 0) first = it + 1;
      // the tile stops together, in its first sweep with no dirty codeword
      if (it + 1 < max_iters &&
          tile_clean(bar + it, unsat != 0, members, &clean_flag))
        break;
    }

    // ---------------- epilogue: the BB frame's bytes ----------------
    // Each thread writes whole 32-bit words of the padded row; a byte is the
    // sign bits of eight posteriors (two 32-bit loads), past k/8 it is zero.
    const int kb = k >> 3;  // k is a multiple of 360
    uint32_t* row = p.packed + (size_t)cw * p.packed_words;
    const uint2* lam8 = reinterpret_cast<const uint2*>(lam);
    for (int j = tid; j < p.packed_words; j += THREADS) {
      unsigned word = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        if (4 * j + b < kb) {
          const uint2 v = lam8[4 * j + b];
          word |= msb_byte(v.x, v.y) << (8 * b);
        }
      }
      row[j] = word;
    }
    if (tid == 0) {
      p.ok[cw] = (int8_t)(unsat == 0);
      p.iters[cw] = unsat == 0 ? first : max_iters;
    }
    if (p.syn != nullptr) {  // the screen's scratch
      if (tid < SYN_WORDS) p.syn[(size_t)cw * SYN_WORDS + tid] = 0;
      if (tid == 0 && cw % SCR_TW == 0) p.done[cw / SCR_TW] = 0;
    }
  }  // the next codeword
}

// ---------------------------------------------------------------------------
// BCH screen over the byte rows: see "The BCH screen" above.  Block
// (x, y, z): codewords [64 x, 64 x + 64) against syndrome rows
// [32 y, 32 y + 32), over the word chunks z * per_split ... of the row.
// Warp w takes codewords 16 w ... 16 w + 15 against all 32 rows: four
// m16n8k256 products a 256-bit step.  The fragments (PTX ISA, mma
// m16n8k256 .b1): lane = 4 g + t; A (row major, 16 x 256 bits) a0 = word
// t of codeword g, a1 of codeword g + 8, a2 and a3 the same at word t + 4;
// B (column major, 256 x 8) b0 = word t of syndrome row g, b1 word t + 4;
// the s32 sums c0, c1 are codeword g against rows 2 t and 2 t + 1, c2, c3
// codeword g + 8.  A word of a codeword meets the same word of H, so the
// order of bits in a word is free.
// ---------------------------------------------------------------------------
constexpr int SCR_THREADS = 2 * SCR_TW;  // one warp a 16-codeword slab
constexpr int SCR_KC = 64;          // words per chunk
constexpr int SCR_LD = SCR_KC + 4;  // row stride: fragment loads without conflicts
constexpr int SCR_ROWS = SCR_TW + SCR_TR;
constexpr int SCR_STAGE = SCR_ROWS * SCR_LD;  // words of one stage
constexpr size_t SCR_SMEM = 2 * SCR_STAGE * sizeof(uint32_t);

__device__ __forceinline__ void cp_async16(uint32_t* dst, const uint32_t* src,
                                           bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  // src-size 0 fills the 16 bytes with zeros and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

// c += popc(a & b) over 256 bits, 16 codewords by 8 syndrome rows
__device__ __forceinline__ void mma_and_popc(int (&c)[4], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(SCR_THREADS)
bch_screen_kernel(const uint32_t* __restrict__ bits,
                  const uint32_t* __restrict__ h, int8_t* __restrict__ clean_out,
                  uint32_t* __restrict__ syn, uint32_t* __restrict__ done,
                  int W, int n_syn, int nw, int per_split) {
  extern __shared__ __align__(16) uint32_t sbuf[];
  __shared__ uint32_t odd_rows[SCR_TW];
  __shared__ int last;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int g = (tid & 31) >> 2, t = tid & 3;
  const int w0 = blockIdx.x * SCR_TW, r0 = blockIdx.y * SCR_TR;
  const int n_chunks = (nw + SCR_KC - 1) / SCR_KC;
  const int c0 = blockIdx.z * per_split;
  const int c1 = min(c0 + per_split, n_chunks);
  if (tid < SCR_TW) odd_rows[tid] = 0;

  // one chunk: 96 rows of 16 16-byte pieces, twelve copies a thread
  auto load_chunk = [&](int chunk, int stage) {
    uint32_t* dst = sbuf + stage * SCR_STAGE;
    for (int e = tid; e < SCR_ROWS * (SCR_KC / 4); e += SCR_THREADS) {
      const int rr = e / (SCR_KC / 4), piece = e % (SCR_KC / 4);
      const int word = chunk * SCR_KC + 4 * piece;
      const bool is_cw = rr < SCR_TW;
      const int gr = is_cw ? w0 + rr : r0 + rr - SCR_TW;
      const bool valid = word < nw && (is_cw ? gr < W : gr < n_syn);
      const uint32_t* src = (is_cw ? bits : h) +
                            (valid ? (size_t)gr * nw + word : 0);
      cp_async16(dst + rr * SCR_LD + 4 * piece, src, valid);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  int acc[SCR_TR / 8][4] = {};
  if (c0 < c1) load_chunk(c0, 0);
  for (int c = c0; c < c1; ++c) {
    const int stage = (c - c0) & 1;
    if (c + 1 < c1) {
      load_chunk(c + 1, stage ^ 1);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    const uint32_t* sa = sbuf + stage * SCR_STAGE + (16 * warp + g) * SCR_LD + t;
    const uint32_t* sb = sbuf + stage * SCR_STAGE + (SCR_TW + g) * SCR_LD + t;
#pragma unroll
    for (int kk = 0; kk < SCR_KC; kk += 8) {
      const uint32_t a0 = sa[kk], a1 = sa[8 * SCR_LD + kk];
      const uint32_t a2 = sa[kk + 4], a3 = sa[8 * SCR_LD + kk + 4];
#pragma unroll
      for (int j = 0; j < SCR_TR / 8; ++j)
        mma_and_popc(acc[j], a0, a1, a2, a3, sb[8 * j * SCR_LD + kk],
                     sb[8 * j * SCR_LD + kk + 4]);
    }
    __syncthreads();  // the stage is refilled next
  }

  // this block's parities, one bit a syndrome row, into the codeword's word
  // of rows [r0, r0 + 32): xor-ed with the other splits' in device memory
  unsigned lo = 0, hi = 0;
#pragma unroll
  for (int j = 0; j < SCR_TR / 8; ++j) {
    const int b = 8 * j + 2 * t;
    lo |= (unsigned)(acc[j][0] & 1) << b | (unsigned)(acc[j][1] & 1) << (b + 1);
    hi |= (unsigned)(acc[j][2] & 1) << b | (unsigned)(acc[j][3] & 1) << (b + 1);
  }
  if (lo) atomicOr(&odd_rows[16 * warp + g], lo);
  if (hi) atomicOr(&odd_rows[16 * warp + g + 8], hi);
  __syncthreads();
  if (tid < SCR_TW && w0 + tid < W && odd_rows[tid])
    atomicXor(&syn[(size_t)(w0 + tid) * SYN_WORDS + blockIdx.y], odd_rows[tid]);
  __threadfence();
  __syncthreads();
  if (tid == 0)
    last = atomicAdd(&done[blockIdx.x], 1u) == gridDim.y * gridDim.z - 1;
  __syncthreads();
  if (!last) return;
  // the tile's last block: every split has added its parities
  __threadfence();
  if (tid < SCR_TW && w0 + tid < W) {
    unsigned any = 0;
    for (int y = 0; y < (int)gridDim.y; ++y)
      any |= __ldcg(&syn[(size_t)(w0 + tid) * SYN_WORDS + y]);
    clean_out[w0 + tid] = (int8_t)(any == 0);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
char g_detail[256] = "";

// Template slots of the kernel that serves (cnl, uniform); 0 = none.  The
// uniform NORMAL tables (and SHORT r2/3) get their exact row weight, the
// others the next size up with predicated slots.  Up to 13 slots the state
// word has 32 bits, as ops/ldpc.py state_word_bits says.
bool exact_slots(int cnl, bool uniform) {
  return uniform && (cnl == 5 || cnl == 8 || cnl == 9 || cnl == 12 ||
                     cnl == 16 || cnl == 20);
}

int template_slots(int cnl, bool uniform) {
  if (exact_slots(cnl, uniform)) return cnl;
  return cnl < 1 ? 0 : cnl <= 5 ? 5 : cnl <= 13 ? 13 : cnl <= 20 ? 20 : 0;
}

size_t shared_bytes(int k, int q, int cnl) {
  const size_t n16 = (size_t)((k + q * M + 15) & ~15);
  return n16 + (size_t)q * cnl * sizeof(int2) + (size_t)q * 4;
}

// The decoder kernel of a template: sets its shared memory, counts the
// blocks that fit the card at once (*capacity), and when `launch` is set
// launches min(W, capacity) of them cooperatively on `stream` (see "Tile
// exit"), after zeroing the ticket and the barrier words.
template <int MAXC, bool UNIFORM, bool FULL>
cudaError_t run(const Params& p, size_t smem, cudaStream_t stream, bool launch,
                int* capacity) {
  auto kern = ldpc_layered_kernel<MAXC, UNIFORM, FULL>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  int device = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&device)) != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS,
                                                    smem);
  if (e != cudaSuccess) return e;
  *capacity = per_sm * sms;
  if (!launch) return cudaSuccess;
  const int need = min(p.W, TILE);  // the largest tile the call can have
  if (*capacity < need) {
    snprintf(g_detail, sizeof g_detail,
             "%d decoder blocks fit this device at once (%d an SM on %d SMs, "
             "%zu B of shared memory each); a tile of %d codewords needs "
             "them all resident",
             *capacity, per_sm, sms, smem, need);
    return cudaErrorCooperativeLaunchTooLarge;
  }
  const size_t counters = 1 + (size_t)p.n_tiles * (p.max_iters - 1);
  e = cudaMemsetAsync(p.ticket, 0, counters * sizeof(unsigned), stream);
  if (e != cudaSuccess) return e;
  void* args[] = {const_cast<Params*>(&p)};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kern),
                                     dim3(min(p.W, *capacity)), dim3(THREADS),
                                     args, smem, stream);
}

cudaError_t dispatch(const Params& p, size_t smem, cudaStream_t stream,
                     bool launch, int* capacity, bool uniform) {
  const int slots = template_slots(p.cnl, uniform);
  if (exact_slots(p.cnl, uniform)) {
    switch (slots) {
      case 5: return run<5, true, true>(p, smem, stream, launch, capacity);
      case 8: return run<8, true, true>(p, smem, stream, launch, capacity);
      case 9: return run<9, true, true>(p, smem, stream, launch, capacity);
      case 12: return run<12, true, true>(p, smem, stream, launch, capacity);
      case 16: return run<16, true, true>(p, smem, stream, launch, capacity);
      default: return run<20, true, true>(p, smem, stream, launch, capacity);
    }
  }
  if (uniform) {
    switch (slots) {
      case 5: return run<5, true, false>(p, smem, stream, launch, capacity);
      case 13: return run<13, true, false>(p, smem, stream, launch, capacity);
      default: return run<20, true, false>(p, smem, stream, launch, capacity);
    }
  }
  switch (slots) {
    case 5: return run<5, false, false>(p, smem, stream, launch, capacity);
    case 13: return run<13, false, false>(p, smem, stream, launch, capacity);
    default: return run<20, false, false>(p, smem, stream, launch, capacity);
  }
}

// Splits of a screen row's words: enough blocks for two on every SM.
int screen_splits(int blocks_xy, int n_chunks, int sms) {
  const int want = (2 * sms + blocks_xy - 1) / blocks_xy;
  return max(1, min(want, n_chunks));
}

}  // namespace

// Dynamic shared memory of one decoder block for a table, or -1 where no
// kernel serves it.
extern "C" int ldpc_layered_shared_bytes(int k, int q, int cnl, int uniform) {
  const int slots = template_slots(cnl, uniform != 0);
  return slots ? (int)shared_bytes(k, q, cnl) : -1;
}

// Launches of the decoder kernel a call makes (see "Tile exit").
extern "C" int ldpc_layered_passes() { return 1; }

// Decoder blocks of a table that fit the current device at once: the
// persistent grid of a call of W codewords is min(W, this).  Negative: a
// cudaError_t, or -1 where no kernel serves the table.
extern "C" int ldpc_layered_capacity(int k, int q, int cnl, int uniform) {
  if (template_slots(cnl, uniform != 0) == 0) return -1;
  Params p{};
  p.cnl = cnl;
  int capacity = 0;
  const cudaError_t e = dispatch(p, shared_bytes(k, q, cnl), nullptr, false,
                                 &capacity, uniform != 0);
  return e == cudaSuccess ? capacity : -(int)e;
}

// Int32 words of scratch a call of W codewords in n_tiles tiles needs (the
// wrapper allocates them; their contents need not be set): the screen's
// syndrome rows and tile counts, the ticket, a barrier word a tile and
// sweep but the last.
extern "C" int ldpc_layered_scratch_words(int W, int n_tiles, int max_iters) {
  return W * SYN_WORDS + (W + SCR_TW - 1) / SCR_TW + 1 +
         n_tiles * (max_iters - 1);
}

// llr int8 [W, k + q*360] in kernel bit order -> packed uint8 [W,
// 4 * packed_words]: the hard bits of [0, k) MSB first (np.packbits), the
// rest of the row zero; ok int8 [W]; iters int32 [W]; clean int8 [W]
// (written when n_syn > 0).  scratch: ldpc_layered_scratch_words(W,
// n_tiles, max_iters) int32.  tiles int32 [n_tiles + 1]: the first
// codeword of each exit tile (128 codewords from each segment's start,
// ops/ldpc.py tile_starts), then W.  slot_tab int32 [q, cnl, 2] = (group
// * 360, shift); row_tab int32 [q] = cnt | nfirst << 8 | sync << 16;
// h_bits uint32 [n_syn, packed_words], H packed as the rows are (n_syn =
// 0: no BCH screen).  Launches the decoder once and behind it the screen
// on `stream`; does not synchronize.  Returns a cudaError_t (0 =
// launched); after cudaErrorInvalidValue or
// cudaErrorCooperativeLaunchTooLarge, last_error_detail() says why.
extern "C" int ldpc_layered_decode(
    const void* llr, void* packed, int packed_words, void* ok, void* iters,
    void* clean, void* scratch, const void* tiles, int n_tiles,
    const void* slot_tab, const void* row_tab, const void* h_bits, int n_syn,
    int W, int k, int q, int cnl, int uniform, int max_iters, void* stream) {
  g_detail[0] = 0;
  if (W == 0) return 0;
  const int slots = template_slots(cnl, uniform != 0);
  if (slots == 0 || q < 2 || q > (slots > 13 ? MAXQ_WIDE : MAXQ_NARROW) ||
      k % M != 0 || max_iters < 1 || packed_words % 4 != 0 ||
      4 * packed_words < k / 8 || n_tiles < 1 || n_tiles > W || n_syn < 0 ||
      n_syn > 32 * SYN_WORDS) {
    snprintf(g_detail, sizeof g_detail,
             "unsupported arguments: k=%d q=%d cnl=%d uniform=%d max_iters=%d "
             "packed_words=%d n_tiles=%d n_syn=%d",
             k, q, cnl, uniform, max_iters, packed_words, n_tiles, n_syn);
    return (int)cudaErrorInvalidValue;
  }
  int device = 0, smem_max = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = shared_bytes(k, q, cnl);
  if (smem > (size_t)smem_max) {
    snprintf(g_detail, sizeof g_detail,
             "one codeword needs %zu B of shared memory (k=%d q=%d cnl=%d: "
             "%d B of posteriors, the rest row tables); a "
             "block of this device may take %d B",
             smem, k, q, cnl, k + q * M, smem_max);
    return (int)cudaErrorInvalidValue;
  }
  uint32_t* s32 = static_cast<uint32_t*>(scratch);
  uint32_t* done = s32 + (size_t)W * SYN_WORDS;
  unsigned* ticket = done + (W + SCR_TW - 1) / SCR_TW;
  Params p{};
  p.llr = static_cast<const int8_t*>(llr);
  p.packed = static_cast<uint32_t*>(packed);
  p.packed_words = packed_words;
  p.ok = static_cast<int8_t*>(ok);
  p.iters = static_cast<int32_t*>(iters);
  p.syn = n_syn > 0 ? s32 : nullptr;
  p.done = done;
  p.ticket = ticket;
  p.barrier = ticket + 1;
  p.tiles = static_cast<const int32_t*>(tiles);
  p.n_tiles = n_tiles;
  p.slot_tab = static_cast<const int2*>(slot_tab);
  p.row_tab = static_cast<const int32_t*>(row_tab);
  p.W = W;
  p.k = k;
  p.q = q;
  p.cnl = cnl;
  p.max_iters = max_iters;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int capacity = 0;
  e = dispatch(p, smem, st, true, &capacity, uniform != 0);
  if (e != cudaSuccess || n_syn == 0) return (int)e;
  e = cudaFuncSetAttribute(bch_screen_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)SCR_SMEM);
  if (e != cudaSuccess) return (int)e;
  const int n_chunks = (packed_words + SCR_KC - 1) / SCR_KC;
  const int gx = (W + SCR_TW - 1) / SCR_TW, gy = (n_syn + SCR_TR - 1) / SCR_TR;
  const int splits = screen_splits(gx * gy, n_chunks, sms);
  const int per_split = (n_chunks + splits - 1) / splits;
  const dim3 grid(gx, gy, (n_chunks + per_split - 1) / per_split);
  bch_screen_kernel<<<grid, SCR_THREADS, SCR_SMEM, st>>>(
      p.packed, static_cast<const uint32_t*>(h_bits),
      static_cast<int8_t*>(clean), p.syn, p.done, W, n_syn, packed_words,
      per_split);
  return (int)cudaGetLastError();
}

extern "C" const char* last_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

extern "C" const char* last_error_detail() { return g_detail; }
