// Layered offset-min-sum LDPC decoder for the DVB-T2 QC-IRA codes, and the
// BCH syndrome screen of its hard bits.  CUDA C++ for Hopper (sm_90a).
//
// Replaces the TPU kernel sdr_receiver_dvb_t2_tpu/ops/ldpc_pallas.py:169
// (make_pallas_decoder -> kernel, pallas_call at :420) with its fused BCH
// epilogue (:369-382) and computes what they compute, with one difference
// in the early exit: the decoder leaves the sweep loop per codeword instead
// of per 128-codeword tile (see ops/ldpc.py).
//
// What bounds it.  The function's own bytes are small (64,800 LLR bytes in
// and 43,200 hard bytes out per NORMAL codeword, ~0.05 ms for 1616
// codewords at 3.35 TB/s).  Its work is 32-bit integer operations, about 34
// instructions per edge and sweep as compiled, most of them compares,
// selects and min/max, which the SM executes at 64 lanes a clock (half its
// float rate), in a chain of check rows that must run in order.  The
// kernel runs at that integer rate (PERF.md), so the design keeps
// everything a sweep touches on the chip and spends as few instructions
// and barriers per row as it can:
//  * one thread block per codeword, 384 threads; thread m < 360 owns check
//    m of every check row (the 360 checks of a row are independent, and
//    each slot's cyclic shift makes its access a permutation of the group);
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
//  * the BCH screen is a second kernel over the packed hard bits: a tile of
//    64 codewords by 32 syndrome rows per block, xor-accumulating a & h, so
//    the packed matrix is read once per 64 codewords, not once per codeword.
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

namespace {

constexpr int M = 360;
constexpr int THREADS = 384;
constexpr int NWARPS = THREADS / 32;
constexpr int CLAMP = 56;
constexpr unsigned KEY_NONE = 0x7fffffffu;  // key of a slot with no message

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

// MAXC: unrolled data slots.  UNIFORM: every row has cnl data slots and the
// syndrome comes from the post-update signs (else from the pre-update signs
// of the slots a row has).  FULL: cnl == MAXC, so no slot is predicated.
template <int MAXC, bool UNIFORM, bool FULL>
__global__ void __launch_bounds__(THREADS, MAXC <= 9 ? 3 : 2)
ldpc_layered_kernel(const int8_t* __restrict__ llr, int8_t* __restrict__ hard,
                    uint32_t* __restrict__ hard_bits,
                    int8_t* __restrict__ ok_out,
                    int32_t* __restrict__ iters_out,
                    int8_t* __restrict__ clean_out,
                    const int2* __restrict__ slot_tab,
                    const int32_t* __restrict__ row_tab, int k, int q,
                    int cnl_arg, int max_iters) {
  constexpr bool WIDE = MAXC > 13;
  using Word = typename StateWord<WIDE>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int red[NWARPS];
  const int cnl = FULL ? MAXC : cnl_arg;
  const int n = k + q * M;
  const int n16 = (n + 15) & ~15;
  int8_t* lam = reinterpret_cast<int8_t*>(smem);  // [k] data, then [q*M] parity
  int8_t* par = lam + k;
  // this lane's word of every row: a per-thread array in local memory
  Word state[WIDE ? MAXQ_WIDE : MAXQ_NARROW];
  int2* stab = reinterpret_cast<int2*>(smem + n16);
  int32_t* rtab = reinterpret_cast<int32_t*>(stab + q * cnl);

  const int cw = blockIdx.x;
  const int tid = threadIdx.x;
  const int m = tid;  // check lane
  const bool active = m < M;

  // row tables, then the channel LLRs clamped below the weakest bit's
  // correction capacity
  for (int j = tid; j < q * cnl; j += THREADS) stab[j] = slot_tab[j];
  for (int j = tid; j < q; j += THREADS) rtab[j] = row_tab[j];
  const int8_t* llr_cw = llr + (size_t)cw * n;
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
#define OLD_MSG(slot)                                   \
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
    if (unsat == 0) {  // per-codeword early exit
      first = it + 1;
      break;
    }
  }

  // ---------------- epilogue: hard bits, as bytes and packed ----------------
  // Four posteriors per thread and step: their sign bits become four hard
  // bytes (one 32-bit store) and a nibble of the packed word, which eight
  // neighbouring lanes put together.
  const uint32_t* lam32 = reinterpret_cast<const uint32_t*>(lam);
  uint32_t* hard32 = reinterpret_cast<uint32_t*>(hard + (size_t)cw * k);
  const int k4 = k / 4;  // k is a multiple of 360
  const int kw = (k + 31) / 32;
  for (int base = 0; base < k4; base += THREADS) {
    const int j = base + tid;
    unsigned y = 0;
    if (j < k4) {
      y = (lam32[j] >> 7) & 0x01010101u;
      hard32[j] = y;
    }
    unsigned nib = (((y * 0x01020408u) >> 24) & 0xFu) << (4 * (tid & 7));
    nib |= __shfl_xor_sync(0xffffffffu, nib, 1);
    nib |= __shfl_xor_sync(0xffffffffu, nib, 2);
    nib |= __shfl_xor_sync(0xffffffffu, nib, 4);
    if (hard_bits != nullptr && (tid & 7) == 0 && j < k4)
      hard_bits[(size_t)cw * kw + (j >> 3)] = nib;
  }
  if (tid == 0) {
    ok_out[cw] = (int8_t)(unsat == 0);
    iters_out[cw] = unsat == 0 ? first : max_iters;
    clean_out[cw] = 1;  // until the screen finds a syndrome bit
  }
}

// ---------------------------------------------------------------------------
// BCH screen: syndrome bit (w, r) = parity of popcount(bits[w] & h[r]).
// The parity of a popcount is linear over xor, so a thread xor-accumulates
// a & h words and takes one popcount at the end.  One block screens a tile
// of 64 codewords against 32 syndrome rows; tiles of the two operands go
// through shared memory in chunks of 64 words, the next chunk's loads in
// flight in registers during the current chunk's products.
// ---------------------------------------------------------------------------
constexpr int SCR_THREADS = 256;
constexpr int SCR_TW = 64;   // codewords per block
constexpr int SCR_TR = 32;   // syndrome rows per block
constexpr int SCR_KC = 64;   // words per chunk
constexpr int SCR_LD = SCR_KC + 4;  // row stride: 16-byte reads, no conflicts

__global__ void __launch_bounds__(SCR_THREADS)
bch_screen_kernel(const uint32_t* __restrict__ bits,
                  const uint32_t* __restrict__ h, int8_t* __restrict__ clean_out,
                  int W, int n_syn, int kw) {
  __shared__ __align__(16) uint32_t sa[SCR_TW][SCR_LD];
  __shared__ __align__(16) uint32_t sb[SCR_TR][SCR_LD];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;  // codewords tx + 16c, rows ty + 16r
  const int w0 = blockIdx.x * SCR_TW, r0 = blockIdx.y * SCR_TR;
  const int col = tid & (SCR_KC - 1), row0 = tid / SCR_KC;
  constexpr int ROWS_PER_PASS = SCR_THREADS / SCR_KC;  // 4
  constexpr int NA = SCR_TW / ROWS_PER_PASS, NB = SCR_TR / ROWS_PER_PASS;
  uint32_t ra[NA], rb[NB];
  uint32_t acc[4][2] = {};

  auto fetch = [&](int k0) {
    const int gk = k0 + col;
#pragma unroll
    for (int j = 0; j < NA; ++j) {
      const int gw = w0 + row0 + ROWS_PER_PASS * j;
      ra[j] = (gw < W && gk < kw) ? __ldg(bits + (size_t)gw * kw + gk) : 0u;
    }
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int gr = r0 + row0 + ROWS_PER_PASS * j;
      rb[j] = (gr < n_syn && gk < kw) ? __ldg(h + (size_t)gr * kw + gk) : 0u;
    }
  };

  fetch(0);
  for (int k0 = 0; k0 < kw; k0 += SCR_KC) {
#pragma unroll
    for (int j = 0; j < NA; ++j) sa[row0 + ROWS_PER_PASS * j][col] = ra[j];
#pragma unroll
    for (int j = 0; j < NB; ++j) sb[row0 + ROWS_PER_PASS * j][col] = rb[j];
    __syncthreads();
    if (k0 + SCR_KC < kw) fetch(k0 + SCR_KC);
#pragma unroll 4
    for (int kk = 0; kk < SCR_KC; kk += 4) {
      uint4 a[4], b[2];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        a[c] = *reinterpret_cast<const uint4*>(&sa[tx + 16 * c][kk]);
#pragma unroll
      for (int r = 0; r < 2; ++r)
        b[r] = *reinterpret_cast<const uint4*>(&sb[ty + 16 * r][kk]);
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          acc[c][r] ^= (a[c].x & b[r].x) ^ (a[c].y & b[r].y) ^
                       (a[c].z & b[r].z) ^ (a[c].w & b[r].w);
    }
    __syncthreads();
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int gw = w0 + tx + 16 * c;
    const int dirty = (__popc(acc[c][0]) | __popc(acc[c][1])) & 1;
    // every writer stores the same 0 over the decoder's 1
    if (dirty && gw < W) clean_out[gw] = 0;
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

struct Args {
  const int8_t* llr;
  int8_t* hard;
  uint32_t* hard_bits;
  int8_t* ok;
  int32_t* iters;
  int8_t* clean;
  const int2* slot_tab;
  const int32_t* row_tab;
  int W, k, q, cnl, max_iters;
  size_t smem;
  cudaStream_t stream;
};

template <int MAXC, bool UNIFORM, bool FULL>
cudaError_t launch(const Args& a) {
  auto kern = ldpc_layered_kernel<MAXC, UNIFORM, FULL>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)a.smem);
  if (e != cudaSuccess) return e;
  kern<<<a.W, THREADS, a.smem, a.stream>>>(a.llr, a.hard, a.hard_bits, a.ok,
                                           a.iters, a.clean, a.slot_tab,
                                           a.row_tab, a.k, a.q, a.cnl,
                                           a.max_iters);
  return cudaGetLastError();
}

cudaError_t dispatch(const Args& a, int slots, bool uniform) {
  if (exact_slots(a.cnl, uniform)) {
    switch (slots) {
      case 5: return launch<5, true, true>(a);
      case 8: return launch<8, true, true>(a);
      case 9: return launch<9, true, true>(a);
      case 12: return launch<12, true, true>(a);
      case 16: return launch<16, true, true>(a);
      default: return launch<20, true, true>(a);
    }
  }
  if (uniform) {
    switch (slots) {
      case 5: return launch<5, true, false>(a);
      case 13: return launch<13, true, false>(a);
      default: return launch<20, true, false>(a);
    }
  }
  switch (slots) {
    case 5: return launch<5, false, false>(a);
    case 13: return launch<13, false, false>(a);
    default: return launch<20, false, false>(a);
  }
}

}  // namespace

// Dynamic shared memory of one decoder block for a table, or -1 where no
// kernel serves it.
extern "C" int ldpc_layered_shared_bytes(int k, int q, int cnl, int uniform) {
  const int slots = template_slots(cnl, uniform != 0);
  return slots ? (int)shared_bytes(k, q, cnl) : -1;
}

// llr int8 [W, k + q*360] in kernel bit order; hard int8 [W, k];
// hard_bits uint32 [W, h_words] (written when n_syn > 0); ok int8 [W];
// iters int32 [W]; clean int8 [W]; slot_tab int32 [q, cnl, 2] = (group * 360,
// shift); row_tab int32 [q] = cnt | nfirst << 8 | sync << 16;
// h_bits uint32 [n_syn, h_words] (n_syn = 0: no BCH screen).
// Launches the decoder, and behind it the screen, on `stream`; does not
// synchronize.  Returns a cudaError_t (0 = launched); after
// cudaErrorInvalidValue, last_error_detail() says which argument.
extern "C" int ldpc_layered_decode(
    const void* llr, void* hard, void* hard_bits, void* ok, void* iters,
    void* clean, const void* slot_tab, const void* row_tab,
    const void* h_bits, int n_syn, int h_words, int W, int k, int q, int cnl,
    int uniform, int max_iters, void* stream) {
  g_detail[0] = 0;
  if (W == 0) return 0;
  const int kw = (k + 31) / 32;
  const int slots = template_slots(cnl, uniform != 0);
  if (slots == 0 || q < 2 || q > (slots > 13 ? MAXQ_WIDE : MAXQ_NARROW) ||
      k % M != 0 || max_iters < 1 ||
      (n_syn > 0 && h_words != kw)) {
    snprintf(g_detail, sizeof g_detail,
             "unsupported arguments: k=%d q=%d cnl=%d uniform=%d max_iters=%d "
             "n_syn=%d h_words=%d (want %d)",
             k, q, cnl, uniform, max_iters, n_syn, h_words, kw);
    return (int)cudaErrorInvalidValue;
  }
  int device = 0, smem_max = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device);
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
  const Args a{static_cast<const int8_t*>(llr),
               static_cast<int8_t*>(hard),
               n_syn > 0 ? static_cast<uint32_t*>(hard_bits) : nullptr,
               static_cast<int8_t*>(ok),
               static_cast<int32_t*>(iters),
               static_cast<int8_t*>(clean),
               static_cast<const int2*>(slot_tab),
               static_cast<const int32_t*>(row_tab),
               W, k, q, cnl, max_iters, smem,
               static_cast<cudaStream_t>(stream)};
  e = dispatch(a, slots, uniform != 0);
  if (e != cudaSuccess || n_syn == 0) return (int)e;
  const dim3 grid((W + SCR_TW - 1) / SCR_TW, (n_syn + SCR_TR - 1) / SCR_TR);
  bch_screen_kernel<<<grid, SCR_THREADS, 0, a.stream>>>(
      a.hard_bits, static_cast<const uint32_t*>(h_bits), a.clean, W, n_syn, kw);
  return (int)cudaGetLastError();
}

extern "C" const char* last_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

extern "C" const char* last_error_detail() { return g_detail; }
