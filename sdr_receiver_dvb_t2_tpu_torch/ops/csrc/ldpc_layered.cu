// Layered offset-min-sum LDPC decoder for the DVB-T2 QC-IRA codes, with the
// BCH syndrome screen fused into its epilogue.  CUDA C++ for Hopper (sm_90a).
//
// Replaces the TPU kernel sdr_receiver_dvb_t2_tpu/ops/ldpc_pallas.py:169
// (make_pallas_decoder -> kernel, pallas_call at :420) and computes what it
// computes, with one difference in the early exit: it leaves the sweep loop
// per codeword instead of per 128-codeword tile (see ops/ldpc.py).
//
// Design: one thread block per codeword, 384 threads; thread m < 360 owns
// check m of every check row (the 360 checks of a row are independent, and
// each slot's cyclic shift makes its access a permutation of the group).
//  * posteriors (data and parity, n bytes) live in dynamic shared memory as
//    int8: every posterior is an integer clipped to +-127, so this is exact;
//  * check-to-variable messages live in global memory as int8, laid out
//    [codeword, row, slot, 360]: each slot's read and write is 360
//    contiguous bytes.  The first sweep reads none (all messages are 0);
//  * the per-row pass-1 values t stay in registers (MAXC template slots).
//
// Bound (H100 SXM, 3.35 TB/s; worked out in PERF.md): the function's own
// inputs and outputs are 64,800 LLR bytes in and 43,200 hard bytes out per
// NORMAL codeword, ~0.05 ms for 1616 codewords; its ~15 integer operations
// per edge and sweep are far below the card's rate.  This design adds the
// message traffic: per sweep after the first a codeword reads and writes
// 216,000 B of messages (q*(cnl+2)*360 for NORMAL r2/3), ~1.9 GB or
// ~0.57 ms for 1616 codewords at 3 sweeps.  It keeps the posteriors, the
// operand read most often, out of device memory entirely and streams the
// messages as coalesced 360-byte rows; compressing them (min1/min2/argmin/
// signs, ~5 B per check) would cut that term ~2x and is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int M = 360;
constexpr int THREADS = 384;
constexpr int NWARPS = THREADS / 32;
constexpr int BIG = 30000;
constexpr int CLAMP = 56;

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

__device__ __forceinline__ void take_min(int mag, int slot, int& m1, int& m2,
                                         int& idx) {
  if (mag < m1) {
    m2 = m1;
    m1 = mag;
    idx = slot;
  } else {
    m2 = min(m2, mag);
  }
}

// Check-to-variable message of one slot: the extrinsic minimum with the
// extrinsic sign, clipped to [-32, 31].
__device__ __forceinline__ int emit(int t, int slot, int idx, int m1, int m2,
                                    bool spar) {
  const int mag = (idx == slot) ? m2 : m1;
  const bool neg = spar ^ (t < 0);
  return min(max(neg ? -mag : mag, -32), 31);
}

__device__ __forceinline__ int clip127(int v) { return min(max(v, -127), 127); }

template <int MAXC, bool UNIFORM>
__global__ void __launch_bounds__(THREADS)
ldpc_layered_kernel(const int8_t* __restrict__ llr, int8_t* __restrict__ hard,
                    int8_t* __restrict__ c2v_all, int8_t* __restrict__ ok_out,
                    int32_t* __restrict__ iters_out,
                    int8_t* __restrict__ clean_out,
                    const int32_t* __restrict__ g_tab,
                    const int32_t* __restrict__ s_tab,
                    const int32_t* __restrict__ cnt_tab,
                    const uint32_t* __restrict__ h_bits, int n_syn,
                    int h_words, int k, int q, int cnl, unsigned rmw_mask,
                    int max_iters) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int red[NWARPS];
  const int n = k + q * M;
  int8_t* lam = reinterpret_cast<int8_t*>(smem);  // [k] data, then [q*M] parity
  int8_t* par = lam + k;
  uint32_t* hbits = reinterpret_cast<uint32_t*>(smem + ((n + 15) & ~15));

  const int cw = blockIdx.x;
  const int tid = threadIdx.x;
  const int m = tid;  // check lane
  const bool active = m < M;
  const int C = cnl + 2;
  const int8_t* llr_cw = llr + (size_t)cw * n;
  int8_t* c2v = c2v_all + (size_t)cw * q * C * M;

  // channel LLRs, clamped below the weakest bit's correction capacity
  for (int j = tid; j < n; j += THREADS)
    lam[j] = (int8_t)min(max((int)llr_cw[j], -CLAMP), CLAMP);
  __syncthreads();

  int unsat = 0, first = 0;
  for (int it = 0; it < max_iters; ++it) {
    const bool fresh = it == 0;
    int my_unsat = 0;
    for (int i = 0; i < q; ++i) {
      int8_t* crow = c2v + (size_t)i * C * M + m;  // slot stride M
      const int32_t* gr = g_tab + i * cnl;
      const int32_t* sr = s_tab + i * cnl;
      const int cnt_i = UNIFORM ? cnl : cnt_tab[i];
      const int ip = i > 0 ? i - 1 : q - 1;
      int t[MAXC], src[MAXC];
      int t_self = 0, t_prev = 0, pm = -1;
      int m1 = BIG, m2 = BIG, idx = 0;
      bool spar = false, syn = false, valid_prev = false;

      // ---------------- pass 1: gather, mins, signs ----------------
      if (active) {
#pragma unroll
        for (int slot = 0; slot < MAXC; ++slot) {
          if (slot < cnt_i) {
            int sidx = m - sr[slot];
            if (sidx < 0) sidx += M;
            src[slot] = gr[slot] * M + sidx;
            const int slab = lam[src[slot]];
            const int tt = slab - (fresh ? 0 : (int)crow[slot * M]);
            if (!UNIFORM) syn ^= slab < 0;
            spar ^= tt < 0;
            take_min(max(abs(tt) - 1, 0), slot, m1, m2, idx);
            t[slot] = tt;
          }
        }
        const int p_self = par[i * M + m];
        t_self = p_self - (fresh ? 0 : (int)crow[cnl * M]);
        if (!UNIFORM) syn ^= p_self < 0;
        spar ^= t_self < 0;
        take_min(max(abs(t_self) - 1, 0), cnl, m1, m2, idx);

        // staircase neighbour: check (row 0, lane 0) has none
        pm = i > 0 ? m : m - 1;
        valid_prev = pm >= 0;
        const int old = fresh ? 0 : (int)crow[(cnl + 1) * M];
        const int p_prev = valid_prev ? (int)par[ip * M + pm] : BIG;
        t_prev = valid_prev ? p_prev - old : BIG;
        if (!UNIFORM) syn ^= valid_prev && p_prev < 0;
        spar ^= valid_prev && t_prev < 0;
        take_min(valid_prev ? max(abs(t_prev) - 1, 0) : BIG, cnl + 1, m1, m2,
                 idx);
      }
      __syncthreads();

      // ---------------- pass 2: emit messages, update -------------
      // first occurrences: lam + msg - old = t + msg, no posterior re-read
      if (active) {
#pragma unroll
        for (int slot = 0; slot < MAXC; ++slot) {
          if (slot < cnt_i && !((rmw_mask >> slot) & 1u)) {
            const int msg = emit(t[slot], slot, idx, m1, m2, spar);
            const int upd = clip127(t[slot] + msg);
            lam[src[slot]] = (int8_t)upd;
            crow[slot * M] = (int8_t)msg;
            if (UNIFORM) syn ^= upd < 0;
          }
        }
      }
      // duplicate-group tail slots: read-modify-write after the writes above
#pragma unroll
      for (int slot = 0; slot < MAXC; ++slot) {
        if (slot < cnl && ((rmw_mask >> slot) & 1u)) {
          __syncthreads();
          if (active && slot < cnt_i) {
            const int msg = emit(t[slot], slot, idx, m1, m2, spar);
            const int old = fresh ? 0 : (int)crow[slot * M];
            const int upd = clip127((int)lam[src[slot]] + msg - old);
            lam[src[slot]] = (int8_t)upd;
            crow[slot * M] = (int8_t)msg;
            if (UNIFORM) syn ^= upd < 0;
          }
        }
      }
      if (active) {
        int msg = emit(t_self, cnl, idx, m1, m2, spar);
        int upd = clip127(t_self + msg);
        par[i * M + m] = (int8_t)upd;
        crow[cnl * M] = (int8_t)msg;
        if (UNIFORM) syn ^= upd < 0;
        msg = emit(t_prev, cnl + 1, idx, m1, m2, spar);
        upd = clip127(t_prev + msg);
        if (valid_prev) par[ip * M + pm] = (int8_t)upd;
        crow[(cnl + 1) * M] = (int8_t)(valid_prev ? msg : 0);
        if (UNIFORM) syn ^= valid_prev && upd < 0;
        my_unsat += syn;
      }
      __syncthreads();
    }
    unsat = block_sum(my_unsat, red);
    if (unsat == 0) {  // per-codeword early exit
      first = it + 1;
      break;
    }
  }

  // ---------------- epilogue: hard bits and BCH syndrome ----------------
  const int kw = (k + 31) / 32;
  const int warp = tid >> 5, lane = tid & 31;
  int8_t* hard_cw = hard + (size_t)cw * k;
  for (int w = warp; w < kw; w += NWARPS) {
    const int j = w * 32 + lane;
    const bool b = j < k && lam[j] < 0;
    const unsigned word = __ballot_sync(0xffffffffu, b);
    if (j < k) hard_cw[j] = (int8_t)b;
    if (lane == 0) hbits[w] = word;
  }
  __syncthreads();
  int dirty = 0;
  for (int r = warp; r < n_syn; r += NWARPS) {
    const uint32_t* hr = h_bits + (size_t)r * h_words;
    int acc = 0;
    for (int w = lane; w < kw; w += 32) acc += __popc(hbits[w] & hr[w]);
    dirty |= warp_sum(acc) & 1;
  }
  dirty = block_sum(dirty, red);
  if (tid == 0) {
    ok_out[cw] = (int8_t)(unsat == 0);
    iters_out[cw] = unsat == 0 ? first : max_iters;
    clean_out[cw] = (int8_t)(dirty == 0);
  }
}

template <int MAXC, bool UNIFORM>
cudaError_t launch(const int8_t* llr, int8_t* hard, int8_t* c2v, int8_t* ok,
                   int32_t* iters, int8_t* clean, const int32_t* g_tab,
                   const int32_t* s_tab, const int32_t* cnt,
                   const uint32_t* h_bits, int n_syn, int h_words, int W,
                   int k, int q, int cnl, unsigned rmw_mask, int max_iters,
                   size_t smem, cudaStream_t stream) {
  auto kern = ldpc_layered_kernel<MAXC, UNIFORM>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<W, THREADS, smem, stream>>>(llr, hard, c2v, ok, iters, clean, g_tab,
                                     s_tab, cnt, h_bits, n_syn, h_words, k, q,
                                     cnl, rmw_mask, max_iters);
  return cudaGetLastError();
}

template <bool UNIFORM>
cudaError_t dispatch(const int8_t* llr, int8_t* hard, int8_t* c2v, int8_t* ok,
                     int32_t* iters, int8_t* clean, const int32_t* g_tab,
                     const int32_t* s_tab, const int32_t* cnt,
                     const uint32_t* h_bits, int n_syn, int h_words, int W,
                     int k, int q, int cnl, unsigned rmw_mask, int max_iters,
                     size_t smem, cudaStream_t stream) {
#define LDPC_LAUNCH(C)                                                       \
  return launch<C, UNIFORM>(llr, hard, c2v, ok, iters, clean, g_tab, s_tab, \
                            cnt, h_bits, n_syn, h_words, W, k, q, cnl,       \
                            rmw_mask, max_iters, smem, stream)
  if (cnl <= 8) LDPC_LAUNCH(8);
  if (cnl <= 12) LDPC_LAUNCH(12);
  LDPC_LAUNCH(20);
#undef LDPC_LAUNCH
}

}  // namespace

// llr int8 [W, k + q*360] in kernel bit order; hard int8 [W, k];
// c2v int8 scratch [W, q, cnl + 2, 360]; ok int8 [W]; iters int32 [W];
// clean int8 [W]; g_tab/s_tab int32 [q, cnl]; cnt int32 [q];
// h_bits uint32 [n_syn, h_words] (n_syn = 0: no BCH screen).
// Launches on `stream`, does not synchronize; returns the launch's
// cudaError_t (0 = launched).
extern "C" int ldpc_layered_decode(
    const void* llr, void* hard, void* c2v, void* ok, void* iters, void* clean,
    const void* g_tab, const void* s_tab, const void* cnt, const void* h_bits,
    int n_syn, int h_words, int W, int k, int q, int cnl, int uniform,
    int rmw_mask, int max_iters, void* stream) {
  if (W == 0) return 0;
  const int kw = (k + 31) / 32;
  if (cnl < 1 || cnl > 20 || q < 2 || (n_syn > 0 && h_words != kw))
    return (int)cudaErrorInvalidValue;
  const int n = k + q * M;
  const size_t smem = (size_t)((n + 15) & ~15) + (size_t)kw * 4;
  auto args = [&](auto fn) {
    return fn(static_cast<const int8_t*>(llr), static_cast<int8_t*>(hard),
              static_cast<int8_t*>(c2v), static_cast<int8_t*>(ok),
              static_cast<int32_t*>(iters), static_cast<int8_t*>(clean),
              static_cast<const int32_t*>(g_tab),
              static_cast<const int32_t*>(s_tab),
              static_cast<const int32_t*>(cnt),
              static_cast<const uint32_t*>(h_bits), n_syn, h_words, W, k, q,
              cnl, (unsigned)rmw_mask, max_iters, smem,
              static_cast<cudaStream_t>(stream));
  };
  cudaError_t e = uniform ? args(dispatch<true>) : args(dispatch<false>);
  return (int)e;
}

extern "C" const char* last_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
