// Single-step decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of stac_st_tpu/ops/pallas/decode_attention.py:
//   decode_self_attention      <- _self_kernel  (:30, wrapper :53)
//   decode_self_attention_anc  <- _anc_kernel   (:82, wrapper :125)
//   decode_cross_attention     <- _cross_kernel (:159, wrapper :182)
//
// Each computes, per (query row, head), softmax(q . K^T + mask) . V with a
// pre-scaled query, fp32 accumulation, and a store in the query's dtype.
// The three differ only in their mask / key source:
//   self:  positions 0..idx of the row's own cache, K^T (BB,H,Dh,S), V (BB,H,S,Dh);
//          idx is one host int, or (the ragged form, continuous batching) an
//          int32 device array of one index per row: row r reads positions
//          0..min(idx[r], S-1), so a row whose index has run past S reads all S;
//   anc:   position s of hypothesis r is read from cache row b*beam + anc[b,r,s]
//          (K and V both (BB,H,S,Dh)); the caches are never reordered; an
//          ancestor outside [0, beam) selects no key and scores -1e9;
//   cross: the beam queries of one utterance against that utterance's encoder
//          K^T (B,H,Dh,S) / V (B,H,S,Dh), stored once, plus an additive (B,S) bias.
//
// Bound: device memory. One decode step reads every cached key and value once
// and does 4*Dh flops per (query, position); at the serving shapes (bf16,
// Dh 64) that is ~1 flop per byte (cross: ~10, the beam shares K/V), far
// below the ~295 flop/byte where the tensor cores would become the limit.
// At those shapes the bytes take 1.3 us (cross, B16 x beam 10 x 251 keys),
// 6.3 us (anc, 195 positions, each row once) and 1.0 us (self, B16 greedy:
// 16 rows x 195 positions), so what holds a kernel back is latency: how
// many blocks run, how many bytes each has in flight, how many passes.
//
// Two designs; which one serves a call is fixed by dtype alone (the
// wrapper's decode_variant names it in the `split` argument):
//
// * split -- bf16 and fp16 (every serving configuration), self, anc and
//   cross. Each (utterance, head) -- each (row, head) for self -- is split
//   over positions into a thread-block cluster of up to 8 blocks, sized at
//   launch from n, the positions read (cross: n = S, 32-position tiles;
//   anc: n = idx + 1, 4-position tiles; self: n = idx + 1, 32-position
//   tiles), so the 64 (b, h) of the main path become 512 blocks (self at
//   B16 greedy: 128 blocks of four warps) on 132 SMs. Each block reads its
//   share with 16-byte loads, all of a tile's in flight at once, runs an
//   online softmax in fp32 (one pass: no score buffer, no second walk over
//   V), and sends its partial (max, sum, unnormalised output) for each
//   query row to the block that owns the row, through distributed shared
//   memory; after one cluster barrier each block combines its rows from
//   every block's partial, always in rank order. One launch per call, no
//   global scratch, no atomics, and two launches give bitwise-equal
//   outputs. (cp.async rings and copy-engine bulk copies were tried for
//   these gathers and were slower than plain 16-byte loads into registers;
//   PERF.md.)
//   - cross_split_kernel: one warp per block, all beam queries of the
//     utterance as the 16 rows of mma.sync.m16n8k16 (beam padded to 16
//     with zero queries), so each encoder key and value is read once per
//     utterance and the beam's reuse happens in the tensor cores. S = Q K^T
//     takes its B fragments from the K^T tile staged in shared memory (each
//     K^T row is read as the 16-byte-aligned chunks that cover it, since S
//     need not be a multiple of 8); O += P V takes P from the score
//     accumulators as two terms of the input type (hi + lo, ~16 bits of
//     P) and V through ldmatrix.trans from a swizzled tile. Positions past
//     S score -inf and the bias is added as the reference adds it, so a row
//     whose every key the bias masks (-1e9) still gets the reference's
//     uniform softmax.
//   - anc_split_kernel: all hypotheses of the utterance in one block, eight
//     threads per hypothesis (eight head dims each). Each thread reads the
//     16 bytes of the K and V rows its hypothesis's ancestors name straight
//     into registers, the next tile's while it computes on this one (rows
//     that hypotheses share come from L2, not HBM); its keys are its own,
//     so the dot products run on the CUDA cores, each 16-byte chunk
//     unpacked to fp32 pairs and reduced over the eight threads with three
//     shuffles. An ancestor outside [0, beam) never becomes an address: its
//     rows are zeros and its score -1e9.
//   - self_split_kernel (self_split_rows_kernel for the ragged form): beam
//     1, one query per (row, head), so a tensor-core product would waste 15
//     of its 16 rows: the CUDA cores, one 32-position
//     tile per warp, up to four warps a block (cluster of ceil(tiles / 4)
//     blocks; the (row, head)s are many at large batch, and fewer, fatter
//     blocks were faster there than one warp a block). K^T is read as cross
//     reads it (the aligned 16-byte chunks that cover each row; the cache
//     segments hold S = 67, 131, 195 positions) and staged in the warp's
//     shared memory, where lane p takes the 64 elements of position p0 + p
//     for its dot product; each lane reads whole 16-byte chunks of V rows
//     straight into registers and weights them by the probability of their
//     position (one shuffle each), so V never passes through shared memory.
//     Every warp sends its partial to the cluster's first block. The row
//     stride S and the positions read n are separate: positions p >= n
//     score -inf (a select, so stale K^T elements in a chunk never reach
//     the sums) and their V rows are never read.
// * simt -- fp32 self, anc and cross: one block of 256 threads per (row,
//   head) -- per (utterance, head) for cross -- scores for all positions in
//   shared memory, an exact two-pass softmax. card_vs_cpu holds fp32
//   decoding to the CPU at 1e-3.
//
// Two kernels replace no Pallas kernel: the int8 cache's
//   decode_self_attention_int8   (split: i8::self_i8_split_kernel, ragged
//                                 i8::self_i8_split_rows_kernel; simt:
//                                 i8::self_i8_kernel, i8::self_i8_rows_kernel)
//   decode_cross_attention_int8  (split: i8::cross_i8_split_kernel; simt:
//                                 i8::cross_i8_kernel)
// stand for the reference's XLA code in stac_st_tpu/models/transformer.py
// _step_int8 (:295) and _step_cross_int8 (:508), whose int8 -> bf16 convert
// XLA fuses into the matmul's operand load (PyTorch would write a copy).
// K^T and V are int8 with one fp32 scale per (row, head, position),
// k_scale / v_scale (rows, H, 1, S); the query arrives unscaled. Per (row,
// head): logit_p = (q . k_p) * (k_scale_p * Dh^-1/2) in fp32, positions past
// the row's count skipped (the reference scores them -1e9: weight 0), the
// cross bias added; an exact softmax in fp32; w_p = softmax_p * v_scale_p
// rounded to the query's type, as the reference rounds it; out = sum w_p *
// v_p in fp32, stored in the query's type. Bound: bytes, 2 * Dh int8 and 8
// bytes of scales per position read (self at 160 rows x 195 positions ~5.1
// us, cross at B16 x 251 ~0.65 us). At the decode shapes what holds a
// kernel back is latency (small launches: every round trip to memory and
// every barrier is on the critical path) or, at 160 rows, device memory
// itself: there the timer's flush leaves L2 full of dirty lines, and a sum
// over the same bytes takes as long as the kernel (PERF.md). The variant
// follows the same rule:
// * split -- bf16 and fp16. Each (row, head) -- each (utterance, head) for
//   cross -- is split over 32-position tiles among the warps of a cluster
//   of up to 8 blocks, a warp per tile (or per two tiles when the launch
//   holds many: every block then fits the card at once), sized at launch
//   from the positions read and the (row, head)s (cross: from S, so the
//   host never reads the bias). A one-block cluster uses the block's own
//   barrier: a cluster barrier costs microseconds. A warp copies each
//   tile into its shared memory with cp.async, keys first: K^T as the five
//   aligned 8-byte chunks that cover a row's 32 bytes (S is odd), k_scale
//   as nine 16-byte chunks; it scores a tile as its keys land, then copies
//   the tile's V rows (16-byte chunks) and v_scale. int8 is converted in
//   two ALU operations a byte, exact in bf16 and fp16. The exact softmax
//   that the reference's rounding of w_p needs is split over the cluster:
//   each warp keeps its logits and sends its per-row (max, sum of
//   exp(l - max)) to every block through distributed shared memory; after
//   one barrier every warp has the row's max M and sum L (sum_u l_u
//   exp(m_u - M), in unit order), forms w_p = exp(l_p - M) / L * v_scale_p
//   rounded to T and adds its w V. The partials, already normalised, are
//   summed in a fixed order in the owner block after a second barrier: K
//   and V are read once, no global scratch, no atomics, bitwise
//   repeatable.
//   - cross: the beam queries are the 16 rows of mma.sync.m16n8k16, so each
//     int8 key and value is read once per utterance (W V takes V through
//     ldmatrix.trans from a swizzled tile converted to T). With a bias the
//     block first reads the bias row (4 bytes a position, against 136 for
//     K, V and the scales) and skips every tile the bias masks whole, as
//     long as the row has a position above NEG_INF / 2 (exact: see the
//     kernel).
//   - self: one query per (row, head), so the CUDA cores (a tensor-core
//     product would waste 15 of its 16 rows): lane p scores position
//     p0 + p; each lane weights 16-byte chunks of four V rows.
// * simt -- fp32: one block of 256 threads per (query row, head) -- for
//   cross the beam queries of an utterance read its K/V from L2 after the
//   first -- the scores in shared memory, two passes. fp32 is held to the
//   CPU at 5e-5 and the fp32 int8 slot loop token for token to its oracle.

// Plain C interface, loaded with ctypes; every launcher returns the
// cudaError_t of the launch (0 = success) or one of the ERR_* codes below.
// Kernels run on the caller's stream, allocate nothing and never
// synchronise.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>

namespace {

constexpr int DH = 64;          // head dim of every preset (d_model / nhead)
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int GROUPS = THREADS / DH;  // position groups in the P.V pass
constexpr int MAX_BEAM = 16;    // hypotheses (queries) per utterance
constexpr float NEG_INF = -1e9f;  // additive mask value of the reference

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) { return __float2half(x); }

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Block-wide reductions through a WARPS-float scratch array.
__device__ float block_max(float x, float* red) {
  x = warp_max(x);
  __syncthreads();  // red may still be read by a previous reduction
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float r = red[0];
  for (int i = 1; i < WARPS; ++i) r = fmaxf(r, red[i]);
  return r;
}

__device__ float block_sum(float x, float* red) {
  x = warp_sum(x);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float r = 0.f;
  for (int i = 0; i < WARPS; ++i) r += red[i];
  return r;
}

// Exact softmax over sc[0..n) in shared memory, in place, whole block.
__device__ void block_softmax(float* sc, int n, float* red) {
  float m = -FLT_MAX;
  for (int s = threadIdx.x; s < n; s += THREADS) m = fmaxf(m, sc[s]);
  m = block_max(m, red);
  float sum = 0.f;
  for (int s = threadIdx.x; s < n; s += THREADS) {
    const float e = expf(sc[s] - m);
    sc[s] = e;
    sum += e;
  }
  sum = block_sum(sum, red);
  for (int s = threadIdx.x; s < n; s += THREADS) sc[s] = sc[s] / sum;
  __syncthreads();
}

// out[d] = sum_s p[s] * V[s, d] for one (row, head); V row of position s
// starts at vrow(s) (nullptr = position skipped). GROUPS position groups of
// DH threads each, reduced through part[THREADS].
template <typename T, typename VRow>
__device__ void block_pv(const float* p, int n, VRow vrow, float* part, T* out) {
  const int d = threadIdx.x % DH;
  const int g = threadIdx.x / DH;
  float acc = 0.f;
  for (int s = g; s < n; s += GROUPS) {
    const T* vr = vrow(s);
    if (vr != nullptr) acc += p[s] * to_f(vr[d]);
  }
  part[threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.x < DH) {
    float o = 0.f;
    for (int i = 0; i < GROUPS; ++i) o += part[i * DH + d];
    out[d] = from_f<T>(o);
  }
}

// The positions row r of the ragged form reads: min(rows[r], S - 1) + 1,
// at least 1 (an index past the cache reads all S).
__device__ __forceinline__ int row_positions(const int32_t* __restrict__ rows, int r, int S) {
  return min(max(__ldg(rows + r), 0), S - 1) + 1;
}

// ---- decode_self_attention, simt (fp32): one block per (row, head) -------
// The body of both forms: this (row, head) reads positions 0..n-1, n =
// n_all, or (RAGGED) its row's own count from rows[].
template <typename T, bool RAGGED>
__device__ __forceinline__ void self_body(const T* __restrict__ q, const T* __restrict__ kT,
                                          const T* __restrict__ v,
                                          const int32_t* __restrict__ rows,
                                          T* __restrict__ out, int H, int S, int n_all) {
  extern __shared__ float sc[];  // [S] scores
  __shared__ float qs[DH];
  __shared__ float red[WARPS];
  __shared__ float part[THREADS];
  const size_t bh = blockIdx.x;  // row * H + head
  const T* kp = kT + bh * DH * S;  // (Dh, S)
  const T* vp = v + bh * S * DH;   // (S, Dh)
  if (threadIdx.x < DH) qs[threadIdx.x] = to_f(q[bh * DH + threadIdx.x]);
  __syncthreads();
  const int n = RAGGED ? row_positions(rows, (int)blockIdx.x / H, S) : n_all;
  for (int s = threadIdx.x; s < n; s += THREADS) {
    float acc = 0.f;
#pragma unroll 16
    for (int d = 0; d < DH; ++d) acc += qs[d] * to_f(kp[(size_t)d * S + s]);
    sc[s] = acc;
  }
  __syncthreads();
  block_softmax(sc, n, red);
  block_pv<T>(sc, n, [&](int s) { return vp + (size_t)s * DH; }, part,
              out + bh * DH);
}

// The scalar form: positions 0..idx.
template <typename T>
__global__ void __launch_bounds__(THREADS)
self_kernel(const T* __restrict__ q, const T* __restrict__ kT,
            const T* __restrict__ v, T* __restrict__ out, int S, int idx) {
  self_body<T, false>(q, kT, v, nullptr, out, 0, S, idx + 1);
}

// The ragged form: row r reads its own positions from rows[r].
template <typename T>
__global__ void __launch_bounds__(THREADS)
self_rows_kernel(const T* __restrict__ q, const T* __restrict__ kT,
                 const T* __restrict__ v, const int32_t* __restrict__ rows,
                 T* __restrict__ out, int H, int S) {
  self_body<T, true>(q, kT, v, rows, out, H, S, S);
}

// ---- decode_self_attention_anc: one block per (hypothesis, head) ---------
template <typename T>
__global__ void __launch_bounds__(THREADS)
anc_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const int32_t* __restrict__ anc,
           T* __restrict__ out, int H, int S, int beam, int idx) {
  extern __shared__ float smem[];
  float* sc = smem;                        // [S] scores
  int* srow = reinterpret_cast<int*>(smem + S);  // [S] source cache row
  __shared__ float qs[DH];
  __shared__ float red[WARPS];
  __shared__ float part[THREADS];
  const int r = blockIdx.x / H;  // hypothesis row b*beam + j
  const int h = blockIdx.x % H;
  const int b = r / beam;
  const int32_t* ap = anc + (size_t)r * S;  // anc[b, j, :]
  const int n = idx + 1;
  for (int s = threadIdx.x; s < n; s += THREADS) {
    const int a = ap[s];
    // an ancestor outside [0, beam) selects no key, as in the TPU kernel's
    // mask; it must never become an address
    srow[s] = (a >= 0 && a < beam) ? b * beam + a : -1;
  }
  if (threadIdx.x < DH) qs[threadIdx.x] = to_f(q[((size_t)r * H + h) * DH + threadIdx.x]);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int s = threadIdx.x >> 5; s < n; s += WARPS) {  // one warp per position
    float acc = NEG_INF;
    if (srow[s] >= 0) {
      const T* kr = k + (((size_t)srow[s] * H + h) * S + s) * DH;
      acc = warp_sum(qs[lane] * to_f(kr[lane]) + qs[lane + 32] * to_f(kr[lane + 32]));
    }
    if (lane == 0) sc[s] = acc;
  }
  __syncthreads();
  block_softmax(sc, n, red);
  block_pv<T>(
      sc, n,
      [&](int s) -> const T* {
        return srow[s] < 0 ? nullptr : v + (((size_t)srow[s] * H + h) * S + s) * DH;
      },
      part, out + ((size_t)r * H + h) * DH);
}

// ---- decode_cross_attention: one block per (utterance, head) -------------
// All beam queries of the utterance share each K column and V row, so the
// encoder K/V is read once per utterance, not once per hypothesis.
template <typename T>
__global__ void __launch_bounds__(THREADS)
cross_kernel(const T* __restrict__ q, const T* __restrict__ kT,
             const T* __restrict__ v, const float* __restrict__ bias,
             T* __restrict__ out, int H, int S, int beam) {
  extern __shared__ float sc[];  // [beam, S] scores
  __shared__ float qs[MAX_BEAM * DH];
  __shared__ float part[GROUPS * MAX_BEAM * DH];
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  for (int i = threadIdx.x; i < beam * DH; i += THREADS) {
    const int j = i / DH, d = i % DH;
    qs[i] = to_f(q[(((size_t)b * beam + j) * H + h) * DH + d]);
  }
  __syncthreads();
  const T* kp = kT + ((size_t)b * H + h) * DH * S;  // (Dh, S)
  const T* vp = v + ((size_t)b * H + h) * S * DH;   // (S, Dh)
  const float* bp = bias == nullptr ? nullptr : bias + (size_t)b * S;
  for (int s = threadIdx.x; s < S; s += THREADS) {
    float kc[DH];
#pragma unroll
    for (int d = 0; d < DH; ++d) kc[d] = to_f(kp[(size_t)d * S + s]);
    const float add = bp == nullptr ? 0.f : bp[s];
    for (int j = 0; j < beam; ++j) {
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) acc += qs[j * DH + d] * kc[d];
      sc[(size_t)j * S + s] = acc + add;
    }
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int j = threadIdx.x >> 5; j < beam; j += WARPS) {  // one warp per query
    float* row = sc + (size_t)j * S;
    float m = -FLT_MAX;
    for (int s = lane; s < S; s += 32) m = fmaxf(m, row[s]);
    m = warp_max(m);
    float sum = 0.f;
    for (int s = lane; s < S; s += 32) {
      const float e = expf(row[s] - m);
      row[s] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int s = lane; s < S; s += 32) row[s] = row[s] / sum;
  }
  __syncthreads();
  const int d = threadIdx.x % DH;
  const int g = threadIdx.x / DH;
  float acc[MAX_BEAM];
#pragma unroll
  for (int j = 0; j < MAX_BEAM; ++j) acc[j] = 0.f;
  for (int s = g; s < S; s += GROUPS) {
    const float vv = to_f(vp[(size_t)s * DH + d]);
#pragma unroll
    for (int j = 0; j < MAX_BEAM; ++j)
      if (j < beam) acc[j] += sc[(size_t)j * S + s] * vv;
  }
#pragma unroll
  for (int j = 0; j < MAX_BEAM; ++j)
    if (j < beam) part[(g * MAX_BEAM + j) * DH + d] = acc[j];
  __syncthreads();
  for (int i = threadIdx.x; i < beam * DH; i += THREADS) {
    const int j = i / DH, dd = i % DH;
    float o = 0.f;
    for (int gg = 0; gg < GROUPS; ++gg) o += part[(gg * MAX_BEAM + j) * DH + dd];
    out[(((size_t)b * beam + j) * H + h) * DH + dd] = from_f<T>(o);
  }
}

// ==== split kernels: bf16 / fp16, position splits in a cluster =============
namespace split {

constexpr int MAX_SPLIT = 8;     // blocks per cluster (the portable maximum)
constexpr int CROSS_TILE = 32;   // cross: positions per tile, one per lane
constexpr int KROW = CROSS_TILE + 8;  // a staged K^T row: the tile + its misalignment
constexpr int ANC_TILE = 4;      // anc: positions per tile, all reads in flight
constexpr int GROUP = 8;         // anc: threads per hypothesis, 8 dims each
constexpr int SELF_TILE = 32;    // self: positions per tile, one per lane
constexpr int SELF_WARPS = 4;    // self: warps per block, at most
constexpr int SLOTS = MAX_BEAM + MAX_SPLIT - 1;  // inbox rows, see Inbox

// The partial results (running max m, sum of exponentials l, unnormalised
// output o) that the cluster's blocks send to the block owning a row. Block
// `rank` owns rows j = lr*cs + rank; the partial of row j from block `src`
// lands in slot src*own + lr, own = ceil(rows / cs) <= SLOTS / cs.
struct __align__(16) Inbox {
  float o[SLOTS][DH];
  float m[SLOTS];
  float l[SLOTS];
};

__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}
__device__ __forceinline__ int cluster_size() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return (int)r;
}
// The address of the same shared variable in block `rank` of the cluster.
template <typename U>
__device__ __forceinline__ U* peer(U* p, int rank) {
  uint64_t r;
  asm volatile("mapa.u64 %0, %1, %2;\n" : "=l"(r) : "l"(p), "r"(rank));
  return reinterpret_cast<U*>(r);
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {  // release
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {  // acquire
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

template <typename T> __device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <> __device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&x);
}
template <> __device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 x = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&x);
}

template <typename T> __device__ __forceinline__ float2 unpack2(uint32_t w);
template <> __device__ __forceinline__ float2 unpack2<__nv_bfloat16>(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w));
}
template <> __device__ __forceinline__ float2 unpack2<__half>(uint32_t w) {
  return __half22float2(*reinterpret_cast<__half2*>(&w));
}

template <typename T> __device__ __forceinline__ float unpack1(uint16_t w);
template <> __device__ __forceinline__ float unpack1<__nv_bfloat16>(uint16_t w) {
  return __uint_as_float((uint32_t)w << 16);
}
template <> __device__ __forceinline__ float unpack1<__half>(uint16_t w) {
  return __half2float(__ushort_as_half(w));
}

// 16 bytes of a read-only tensor, or zeros when !ok (nothing is read).
__device__ __forceinline__ uint4 ld16(const void* p, bool ok) {
  return ok ? __ldg(reinterpret_cast<const uint4*>(p)) : make_uint4(0u, 0u, 0u, 0u);
}

// c += a . b on the tensor cores, fp32 accumulators (m16n8k16, A row-major,
// B column-major, fragments as the PTX ISA lays them out).
template <typename T>
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  if constexpr (std::is_same<T, __half>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
}

// Row j's partial goes to its owner's inbox (distributed shared memory).
// The cluster barrier's first phase, arrived at (relaxed) when the block
// started, is waited for by the caller before the first send: every block
// of the cluster is then running and its inbox exists.
struct Sender {
  Inbox* inbox;  // this block's own, mapped to the owner's per row
  int cs, rank, own;
  __device__ Inbox* box(int j) const { return peer(inbox, j % cs); }
  __device__ int slot(int j) const { return rank * own + j / cs; }
};

// After every block has sent (second barrier phase: release on arrive,
// acquire on wait), block `rank` combines the rows it owns from its own
// inbox, sources in rank order (the result does not depend on timing), and
// stores row j of utterance b, head h at out[((b*beam + j)*H + h)*DH].
// Nothing reads this block's memory afterwards, so it may exit.
template <typename T>
__device__ void combine_own(const Sender& snd, int rows, T* out, int b, int beam, int H,
                            int h) {
  cluster_arrive();
  cluster_wait();
  const Inbox& in = *snd.inbox;
  const int cs = snd.cs, own = snd.own;
  for (int e = threadIdx.x; e < own * (DH / 2); e += blockDim.x) {
    const int lr = e / (DH / 2), d = (e % (DH / 2)) * 2;
    const int j = lr * cs + snd.rank;
    if (j >= rows) continue;
    float M = -INFINITY;
    for (int src = 0; src < cs; ++src) M = fmaxf(M, in.m[src * own + lr]);
    float l = 0.f, o0 = 0.f, o1 = 0.f;
    for (int src = 0; src < cs; ++src) {
      const int sl = src * own + lr;
      const float w = __expf(in.m[sl] - M);
      l += w * in.l[sl];
      o0 += w * in.o[sl][d];
      o1 += w * in.o[sl][d + 1];
    }
    *reinterpret_cast<uint32_t*>(out + (((size_t)b * beam + j) * H + h) * DH + d) =
        pack2<T>(o0 / l, o1 / l);
  }
}

struct CrossTile {
  __align__(16) uint16_t k[DH * KROW];        // K^T rows, as read
  __align__(16) uint16_t v[CROSS_TILE * DH];  // V rows, 16-byte chunks swizzled
  float bias[CROSS_TILE];
};

// ---- decode_cross_attention, split: one warp per (utterance, head, split) --
// `tiles` = ceil(S / CROSS_TILE); the cluster's blocks share them in order.
template <typename T>
__global__ void __launch_bounds__(32)
cross_split_kernel(const T* __restrict__ q, const T* __restrict__ kT,
                   const T* __restrict__ v, const float* __restrict__ bias,
                   T* __restrict__ out, int H, int S, int beam, int tiles) {
  __shared__ Inbox inbox;
  __shared__ CrossTile tile;
  cluster_arrive_relaxed();
  const int cs = cluster_size(), rank = cluster_rank();
  const int bh = blockIdx.x / cs, b = bh / H, h = bh % H;
  const int t0 = rank * tiles / cs, t1 = (rank + 1) * tiles / cs;
  const int lane = threadIdx.x;
  const int g = lane >> 2, qd = lane & 3;  // fragment row group, thread in quad
  const T* kp = kT + (size_t)bh * DH * S;  // this (b, h)'s K^T, 16-byte aligned
  const T* vp = v + (size_t)bh * S * DH;
  const float* bp = bias == nullptr ? nullptr : bias + (size_t)b * S;

  // Q as the A operand: rows are the beam queries, zero past beam
  uint32_t qa[4][4];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = g + (e & 1) * 8, dim = ks * 16 + qd * 2 + (e >> 1) * 8;
      qa[ks][e] = row < beam ? *reinterpret_cast<const uint32_t*>(
                                   q + (((size_t)b * beam + row) * H + h) * DH + dim)
                             : 0u;
    }

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows g, g + 8
  float o[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;

  for (int t = t0; t < t1; ++t) {
    const int p0 = t * CROSS_TILE, pend = min(p0 + CROSS_TILE, S);
    // Every read of the tile in flight at once. K^T row d holds the tile at
    // elements [d*S + p0, d*S + pend) of the (b, h) slab: read the five
    // aligned 16-byte chunks from floor8 of the first (a chunk with none
    // of the row's elements is zeros); V rows past S are zeros.
    uint4 kr[DH * 5 / 32], vr[CROSS_TILE * 8 / 32];
#pragma unroll
    for (int i = 0; i < DH * 5 / 32; ++i) {
      const int idx = lane + 32 * i, d = idx / 5, c = idx % 5;
      const int a = ((d * S + p0) & ~7) + 8 * c;
      kr[i] = ld16(kp + a, a < d * S + pend);
    }
#pragma unroll
    for (int i = 0; i < CROSS_TILE * 8 / 32; ++i) {
      const int r = (lane >> 3) + 4 * i, c = lane & 7;  // position in tile, chunk
      vr[i] = ld16(vp + (size_t)(p0 + r) * DH + 8 * c, p0 + r < S);
    }
    const float br = bp != nullptr && p0 + lane < S ? __ldg(bp + p0 + lane) : 0.f;
    __syncwarp();  // the previous tile's reads of shared memory are done
#pragma unroll
    for (int i = 0; i < DH * 5 / 32; ++i) {
      const int idx = lane + 32 * i, d = idx / 5, c = idx % 5;
      *reinterpret_cast<uint4*>(&tile.k[d * KROW + 8 * c]) = kr[i];
    }
#pragma unroll
    for (int i = 0; i < CROSS_TILE * 8 / 32; ++i) {
      const int r = (lane >> 3) + 4 * i, c = lane & 7;
      *reinterpret_cast<uint4*>(&tile.v[r * DH + 8 * (c ^ (r & 7))]) = vr[i];
    }
    tile.bias[lane] = br;
    __syncwarp();
    // S = Q K^T over four 8-position n-tiles
    float s[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
      const int p = nt * 8 + g;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t kb[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {  // dims d0, d0+1, d0+8, d0+9
          const int d = ks * 16 + qd * 2 + (e & 1) + (e >> 1) * 8;
          kb[e] = tile.k[d * KROW + ((d * S + p0) & 7) + p];
        }
        mma16816<T>(s[nt], qa[ks], kb[0] | (kb[1] << 16), kb[2] | (kb[3] << 16));
      }
    }
    // bias and the ragged edge, then the online softmax (rows g and g + 8;
    // the four threads of a quad share a row)
    float tm[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + qd * 2 + (e & 1);
        float x = s[nt][e];
        if (bp != nullptr) x += tile.bias[c];
        s[nt][e] = p0 + c < S ? x : -INFINITY;
        tm[e >> 1] = fmaxf(tm[e >> 1], s[nt][e]);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tm[r] = fmaxf(tm[r], __shfl_xor_sync(0xffffffffu, tm[r], 1));
      tm[r] = fmaxf(tm[r], __shfl_xor_sync(0xffffffffu, tm[r], 2));
      const float mn = fmaxf(m[r], tm[r]);  // finite: every tile has a key
      alpha[r] = __expf(m[r] - mn);
      m[r] = mn;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = __expf(s[nt][e] - m[e >> 1]);
        l[e >> 1] += s[nt][e];
      }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nt][e] *= alpha[e >> 1];
    // O += P V: P from the score accumulators as two terms of the input
    // type, hi + lo (about 16 bits of P, where one term would keep 8 and
    // put one rounding of up to 2^-9 into every weight), V through
    // ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t ph[4], pl[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* pe = &s[2 * kk + (e >> 1)][(e & 1) * 2];
        ph[e] = pack2<T>(pe[0], pe[1]);
        const float2 hi = unpack2<T>(ph[e]);
        pl[e] = pack2<T>(pe[0] - hi.x, pe[1] - hi.y);
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        const int mat = lane >> 3, row = lane & 7;
        const int pos = kk * 16 + (mat & 1) * 8 + row, chunk = 2 * np + (mat >> 1);
        uint32_t vb[4];
        ldsm_x4_trans(vb, &tile.v[pos * DH + 8 * (chunk ^ (pos & 7))]);
        mma16816<T>(o[2 * np], ph, vb[0], vb[1]);
        mma16816<T>(o[2 * np], pl, vb[0], vb[1]);
        mma16816<T>(o[2 * np + 1], ph, vb[2], vb[3]);
        mma16816<T>(o[2 * np + 1], pl, vb[2], vb[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const Sender snd{&inbox, cs, rank, (beam + cs - 1) / cs};
  cluster_wait();  // every block of the cluster has started
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = g + 8 * r;
    if (j >= beam) continue;
    Inbox* box = snd.box(j);
    const int sl = snd.slot(j);
    if (qd == 0) {
      box->m[sl] = m[r];
      box->l[sl] = l[r];
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      *reinterpret_cast<float2*>(&box->o[sl][nt * 8 + qd * 2]) =
          make_float2(o[nt][2 * r], o[nt][2 * r + 1]);
  }
  combine_own<T>(snd, beam, out, b, beam, H, h);
}

// ---- decode_self_attention_anc, split: one block per (utterance, head,
// split), GROUP threads per hypothesis. `tiles` = ceil(n / ANC_TILE); `span`
// = positions of the longest split (sizes the ancestor table in dynamic
// shared memory, rows[beam][span]). Each thread reads the 16 bytes of each
// K and V row it needs (the row its hypothesis's ancestor names) straight
// into registers, the next tile's while it computes on this one.
template <typename T>
__global__ void __launch_bounds__(GROUP * MAX_BEAM)
anc_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int32_t* __restrict__ anc,
                 T* __restrict__ out, int H, int S, int beam, int n, int tiles, int span) {
  __shared__ Inbox inbox;
  extern __shared__ int srow[];  // source cache row per (hypothesis, position), or -1
  cluster_arrive_relaxed();
  const int cs = cluster_size(), rank = cluster_rank();
  const int bh = blockIdx.x / cs, b = bh / H, h = bh % H;
  const int t0 = rank * tiles / cs, t1 = (rank + 1) * tiles / cs;
  const int P0 = t0 * ANC_TILE, P1 = min(t1 * ANC_TILE, n);
  const int tid = threadIdx.x, nthr = blockDim.x, items = beam * span;

  // the ancestor table of this split, PRE reads in flight per thread
  constexpr int PRE = 8;
  for (int base = tid; base < items; base += PRE * nthr) {
    int a[PRE];
#pragma unroll
    for (int u = 0; u < PRE; ++u) {
      const int i = base + u * nthr, j = i / span, p = P0 + i % span;
      a[u] = i < items && p < P1 ? anc[((size_t)b * beam + j) * S + p] : -1;
    }
#pragma unroll
    for (int u = 0; u < PRE; ++u) {
      const int i = base + u * nthr;
      // an ancestor outside [0, beam) never becomes an address
      if (i < items) srow[i] = a[u] >= 0 && a[u] < beam ? b * beam + a[u] : -1;
    }
  }

  const int j = tid / GROUP, sub = tid % GROUP;
  const int jr = min(j, beam - 1);  // a padding group mirrors the last hypothesis
  float qf[8];
  {
    const uint4 w = __ldg(reinterpret_cast<const uint4*>(
        q + (((size_t)b * beam + jr) * H + h) * DH + sub * 8));
    const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = unpack2<T>(ws[i]);
      qf[2 * i] = f.x;
      qf[2 * i + 1] = f.y;
    }
  }
  __syncthreads();  // srow complete

  struct Tile {
    uint4 k[ANC_TILE], v[ANC_TILE];
    int row[ANC_TILE];  // source cache row, -1 (no key) or -2 (past the split)
  };
  auto fetch = [&](int t, Tile& x) {
#pragma unroll
    for (int i = 0; i < ANC_TILE; ++i) {
      const int p = t * ANC_TILE + i;
      const int r = p < P1 ? srow[jr * span + p - P0] : -1;
      const size_t off = (((size_t)max(r, 0) * H + h) * S + p) * DH + sub * 8;
      x.row[i] = p < P1 ? r : -2;
      x.k[i] = ld16(k + off, r >= 0);
      x.v[i] = ld16(v + off, r >= 0);
    }
  };

  float m = -INFINITY, l = 0.f, o[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i] = 0.f;
  Tile cur, nxt;
  fetch(t0, cur);
  for (int t = t0; t < t1; ++t) {
    if (t + 1 < t1) fetch(t + 1, nxt);
    float s[ANC_TILE];
    float tm = -INFINITY;
#pragma unroll
    for (int i = 0; i < ANC_TILE; ++i) {
      const uint32_t ws[4] = {cur.k[i].x, cur.k[i].y, cur.k[i].z, cur.k[i].w};
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float2 f = unpack2<T>(ws[c]);
        acc = fmaf(qf[2 * c], f.x, acc);
        acc = fmaf(qf[2 * c + 1], f.y, acc);
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      acc += __shfl_xor_sync(0xffffffffu, acc, 4);
      s[i] = cur.row[i] == -2 ? -INFINITY : (cur.row[i] >= 0 ? acc : NEG_INF);
      tm = fmaxf(tm, s[i]);
    }
    const float mn = fmaxf(m, tm);  // finite: every tile has a position < n
    const float alpha = __expf(m - mn);
    m = mn;
    l *= alpha;
#pragma unroll
    for (int d = 0; d < 8; ++d) o[d] *= alpha;
#pragma unroll
    for (int i = 0; i < ANC_TILE; ++i) {  // rows not read are zeros
      const float w = __expf(s[i] - m);
      l += w;
      const uint32_t ws[4] = {cur.v[i].x, cur.v[i].y, cur.v[i].z, cur.v[i].w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float2 f = unpack2<T>(ws[c]);
        o[2 * c] = fmaf(w, f.x, o[2 * c]);
        o[2 * c + 1] = fmaf(w, f.y, o[2 * c + 1]);
      }
    }
    cur = nxt;
  }

  const Sender snd{&inbox, cs, rank, (beam + cs - 1) / cs};
  cluster_wait();  // every block of the cluster has started
  if (j < beam) {
    Inbox* box = snd.box(j);
    const int sl = snd.slot(j);
    if (sub == 0) {
      box->m[sl] = m;
      box->l[sl] = l;
    }
    float4* po = reinterpret_cast<float4*>(&box->o[sl][sub * 8]);
    po[0] = make_float4(o[0], o[1], o[2], o[3]);
    po[1] = make_float4(o[4], o[5], o[6], o[7]);
  }
  combine_own<T>(snd, beam, out, b, beam, H, h);
}

// self_split_kernel's dynamic shared memory: per warp, q in fp32 and its
// staged K^T tile; then, read in the owner block (rank 0), the partials of
// the `units` = cluster size x warps that share the (row, head).
constexpr size_t SELF_WARP_BYTES = DH * sizeof(float) + DH * KROW * sizeof(uint16_t);
size_t self_smem(int warps, int units) {
  return warps * SELF_WARP_BYTES + (size_t)units * (DH + 2) * sizeof(float);
}

// ---- decode_self_attention, split: a cluster of blocks per (row, head) ----
// Positions 0..n-1 (n = idx + 1) of the row's S-position cache, in `tiles`
// = ceil(n / SELF_TILE) tiles; the cluster's blocks and their warps (unit
// u = rank * warps + warp) share them in order, one online softmax per
// warp. The ragged form (RAGGED, self_split_rows_kernel) is launched with
// n = S, so the host needs no index; each row reads its own
// min(rows[r], S - 1) + 1 positions, and a unit whose tiles all lie past
// them reads nothing and sends the empty partial. The two forms are two
// kernels over this one body, so the scalar kernel keeps its own
// parameters. Each warp sends its partial to slot u of rank 0, which
// combines the slots in order after one cluster barrier and stores
// out[(row*H + h)*DH]. Four blocks an SM (at most 128 registers a
// thread): with 140, three fit and the 160-row case read about a
// microsecond slower.
template <typename T, bool RAGGED>
__device__ __forceinline__ void self_split_body(const T* __restrict__ q,
                                                const T* __restrict__ kT,
                                                const T* __restrict__ v,
                                                const int32_t* __restrict__ rows,
                                                T* __restrict__ out, int H, int S,
                                                int n_all, int tiles) {
  extern __shared__ __align__(16) unsigned char self_smem_raw[];
  cluster_arrive_relaxed();
  const int cs = cluster_size(), rank = cluster_rank();
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int units = cs * warps, u = rank * warps + warp;
  float* qs = reinterpret_cast<float*>(self_smem_raw + warp * SELF_WARP_BYTES);
  uint16_t* kt = reinterpret_cast<uint16_t*>(qs + DH);  // K^T rows, as read
  float* po = reinterpret_cast<float*>(self_smem_raw + warps * SELF_WARP_BYTES);
  float* pm = po + units * DH;  // slot maxima
  float* pl = pm + units;       // slot sums
  const int bh = blockIdx.x / cs;  // row * H + head
  const int n = RAGGED ? row_positions(rows, bh / H, S) : n_all;
  const int t0 = u * tiles / units;
  const int t1 = RAGGED ? min((u + 1) * tiles / units, (n + SELF_TILE - 1) / SELF_TILE)
                        : (u + 1) * tiles / units;
  const int c = lane & 7, r0 = lane >> 3;  // V: chunk (dims 8c..8c+7), first row
  const T* kp = kT + (size_t)bh * DH * S;  // this (row, head)'s K^T, 16-byte aligned
  const T* vp = v + (size_t)bh * S * DH;
  // q's two elements of this lane; stored to qs once the first tile's reads
  // are in flight, so the two loads overlap
  const uint32_t qw = __ldg(reinterpret_cast<const uint32_t*>(q + (size_t)bh * DH) + lane);

  float m = -INFINITY, l = 0.f, o[8];  // l: this lane's share of the sum
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i] = 0.f;

  for (int t = t0; t < t1; ++t) {
    const int p0 = t * SELF_TILE, pend = min(p0 + SELF_TILE, n);
    // Every read of the tile in flight at once: K^T as cross reads it (a
    // chunk with none of the row's first pend - p0 elements is zeros), and
    // V rows r0 + 4i, never a row past n.
    uint4 kr[DH * 5 / 32], vr[SELF_TILE * 8 / 32];
#pragma unroll
    for (int i = 0; i < DH * 5 / 32; ++i) {
      const int idx = lane + 32 * i, d = idx / 5, cc = idx % 5;
      const int a = ((d * S + p0) & ~7) + 8 * cc;
      kr[i] = ld16(kp + a, a < d * S + pend);
    }
#pragma unroll
    for (int i = 0; i < SELF_TILE * 8 / 32; ++i) {
      const int p = p0 + r0 + 4 * i;
      vr[i] = ld16(vp + (size_t)p * DH + 8 * c, p < n);
    }
    __syncwarp();  // the previous tile's reads of shared memory are done
    if (t == t0) {
      const float2 f = unpack2<T>(qw);
      qs[2 * lane] = f.x;
      qs[2 * lane + 1] = f.y;
    }
#pragma unroll
    for (int i = 0; i < DH * 5 / 32; ++i) {
      const int idx = lane + 32 * i, d = idx / 5, cc = idx % 5;
      *reinterpret_cast<uint4*>(&kt[d * KROW + 8 * cc]) = kr[i];
    }
    __syncwarp();
    // the score of position p0 + lane, four chains
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int d = 0; d < DH; ++d)
      acc[d & 3] = fmaf(qs[d], unpack1<T>(kt[d * KROW + ((d * S + p0) & 7) + lane]), acc[d & 3]);
    const float s = p0 + lane < n ? (acc[0] + acc[1]) + (acc[2] + acc[3]) : -INFINITY;
    const float mn = fmaxf(m, warp_max(s));  // finite: every tile has a position < n
    const float alpha = __expf(m - mn);
    m = mn;
    const float w = __expf(s - m);  // 0 past n
    l = l * alpha + w;
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] *= alpha;
#pragma unroll
    for (int i = 0; i < SELF_TILE * 8 / 32; ++i) {  // rows not read are zeros
      const float wr = __shfl_sync(0xffffffffu, w, r0 + 4 * i);
      const uint32_t ws[4] = {vr[i].x, vr[i].y, vr[i].z, vr[i].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = unpack2<T>(ws[e]);
        o[2 * e] = fmaf(wr, f.x, o[2 * e]);
        o[2 * e + 1] = fmaf(wr, f.y, o[2 * e + 1]);
      }
    }
  }

  // lanes c, c + 8, c + 16, c + 24 hold the same eight dims
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    o[i] += __shfl_xor_sync(0xffffffffu, o[i], 8);
    o[i] += __shfl_xor_sync(0xffffffffu, o[i], 16);
  }
  l = warp_sum(l);
  cluster_wait();  // every block of the cluster has started
  // a unit with no tile sends m = -inf, l = 0, o = 0: weight 0 below
  float* box = peer(po, 0);
  if (lane == 0) {
    peer(pm, 0)[u] = m;
    peer(pl, 0)[u] = l;
  }
  if (lane < 8) {
    float4* dst = reinterpret_cast<float4*>(box + u * DH + 8 * lane);
    dst[0] = make_float4(o[0], o[1], o[2], o[3]);
    dst[1] = make_float4(o[4], o[5], o[6], o[7]);
  }
  cluster_arrive();  // release: the partials are sent
  cluster_wait();    // acquire: every partial has arrived
  if (rank != 0 || warp != 0) return;
  float M = -INFINITY;
  for (int k = 0; k < units; ++k) M = fmaxf(M, pm[k]);
  float L = 0.f, o0 = 0.f, o1 = 0.f;
  for (int k = 0; k < units; ++k) {  // in slot order: bitwise repeatable
    const float wk = __expf(pm[k] - M);
    L += wk * pl[k];
    o0 += wk * po[k * DH + 2 * lane];
    o1 += wk * po[k * DH + 2 * lane + 1];
  }
  *reinterpret_cast<uint32_t*>(out + (size_t)bh * DH + 2 * lane) = pack2<T>(o0 / L, o1 / L);
}

// The scalar form: positions 0..n-1 of every row.
template <typename T>
__global__ void __launch_bounds__(32 * SELF_WARPS, 4)
self_split_kernel(const T* __restrict__ q, const T* __restrict__ kT,
                  const T* __restrict__ v, T* __restrict__ out, int S, int n, int tiles) {
  self_split_body<T, false>(q, kT, v, nullptr, out, 0, S, n, tiles);
}

// The ragged form, launched on all S positions: row r reads its own.
template <typename T>
__global__ void __launch_bounds__(32 * SELF_WARPS, 4)
self_split_rows_kernel(const T* __restrict__ q, const T* __restrict__ kT,
                       const T* __restrict__ v, const int32_t* __restrict__ rows,
                       T* __restrict__ out, int H, int S, int tiles) {
  self_split_body<T, true>(q, kT, v, rows, out, H, S, S, tiles);
}

}  // namespace split

// dtype codes shared with the Python wrapper
enum DType { F32 = 0, BF16 = 1, F16 = 2 };

// Raise a kernel's dynamic shared-memory limit on the launching (current)
// device, to the largest size asked for so far there (the default cap is
// 48 KB including static memory). cudaFuncSetAttribute acts on the current
// device only and one process may launch on several cards (a serving
// mesh), so each kernel keeps the size raised per device ordinal. Serving
// launches from several host threads, so the check and the raise happen
// under one lock.
constexpr int SMEM_DEVICES = 64;
struct SmemRaised {
  size_t by_device[SMEM_DEVICES] = {};
};
std::mutex smem_mutex;

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem, SmemRaised& raised) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= SMEM_DEVICES) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> hold(smem_mutex);
  size_t& allowed = raised.by_device[dev];
  if (smem <= allowed) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) allowed = smem;
  return e;
}

template <typename T>
cudaError_t launch_self(const void* q, const void* kT, const void* v, void* out,
                        int BB, int H, int S, int idx, cudaStream_t st) {
  const size_t smem = (size_t)S * sizeof(float);
  static SmemRaised raised;
  cudaError_t e = allow_smem(self_kernel<T>, smem, raised);
  if (e != cudaSuccess) return e;
  self_kernel<T><<<BB * H, THREADS, smem, st>>>(
      (const T*)q, (const T*)kT, (const T*)v, (T*)out, S, idx);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_self_rows(const void* q, const void* kT, const void* v, const void* rows,
                             void* out, int BB, int H, int S, cudaStream_t st) {
  const size_t smem = (size_t)S * sizeof(float);
  static SmemRaised raised;
  cudaError_t e = allow_smem(self_rows_kernel<T>, smem, raised);
  if (e != cudaSuccess) return e;
  self_rows_kernel<T><<<BB * H, THREADS, smem, st>>>(
      (const T*)q, (const T*)kT, (const T*)v, (const int32_t*)rows, (T*)out, H, S);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_anc(const void* q, const void* k, const void* v, const void* anc,
                       void* out, int BB, int H, int S, int beam, int idx,
                       cudaStream_t st) {
  const size_t smem = (size_t)S * (sizeof(float) + sizeof(int));
  static SmemRaised raised;
  cudaError_t e = allow_smem(anc_kernel<T>, smem, raised);
  if (e != cudaSuccess) return e;
  anc_kernel<T><<<BB * H, THREADS, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int32_t*)anc, (T*)out, H, S, beam,
      idx);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_cross(const void* q, const void* kT, const void* v, const void* bias,
                         void* out, int B, int H, int S, int beam, cudaStream_t st) {
  const size_t smem = (size_t)beam * S * sizeof(float);
  static SmemRaised raised;
  cudaError_t e = allow_smem(cross_kernel<T>, smem, raised);
  if (e != cudaSuccess) return e;
  cross_kernel<T><<<B * H, THREADS, smem, st>>>(
      (const T*)q, (const T*)kT, (const T*)v, (const float*)bias, (T*)out, H, S, beam);
  return cudaGetLastError();
}

// A launch of `blocks` blocks in clusters of `cs` along x.
struct ClusterLaunch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  ClusterLaunch(int blocks, int cs, int threads, size_t smem, cudaStream_t st) {
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cs;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

template <typename T>
cudaError_t launch_anc_split(const void* q, const void* k, const void* v, const void* anc,
                             void* out, int BB, int H, int S, int beam, int idx,
                             cudaStream_t st) {
  using namespace split;
  const int n = idx + 1;
  const int tiles = (n + ANC_TILE - 1) / ANC_TILE;
  const int cs = tiles < MAX_SPLIT ? tiles : MAX_SPLIT;
  const int span = (tiles + cs - 1) / cs * ANC_TILE;
  const int threads = GROUP * ((beam + 3) / 4 * 4);  // whole warps
  const size_t smem = (size_t)beam * span * sizeof(int);
  static SmemRaised raised;
  cudaError_t e = allow_smem(anc_split_kernel<T>, smem, raised);
  if (e != cudaSuccess) return e;
  ClusterLaunch L(BB / beam * H * cs, cs, threads, smem, st);
  e = cudaLaunchKernelEx(&L.cfg, anc_split_kernel<T>, (const T*)q, (const T*)k, (const T*)v,
                         (const int32_t*)anc, (T*)out, H, S, beam, n, tiles, span);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// The shape of a self launch: a cluster of `cs` blocks of `warps` warps per
// (row, head), one unit (warp) per tile as far as 8 blocks of SELF_WARPS
// allow. The rule, from the tiles alone, was the fastest or within 0.35 us
// of it at every main-path shape of tools/probe_self_split.py (PERF.md).
struct SelfShape {
  int cs, warps;
};
SelfShape self_shape(int tiles) {
  const int warps = tiles < split::SELF_WARPS ? tiles : split::SELF_WARPS;
  const int cs = (tiles + warps - 1) / warps;
  return {cs < split::MAX_SPLIT ? cs : split::MAX_SPLIT, warps};
}

template <typename T>
cudaError_t launch_self_split(const void* q, const void* kT, const void* v, void* out,
                              int BB, int H, int S, int idx, SelfShape sh,
                              cudaStream_t st) {
  using namespace split;
  const int n = idx + 1;
  const int tiles = (n + SELF_TILE - 1) / SELF_TILE;
  const size_t smem = self_smem(sh.warps, sh.cs * sh.warps);
  static SmemRaised raised;
  cudaError_t e = allow_smem(self_split_kernel<T>, smem, raised);
  if (e != cudaSuccess) return e;
  ClusterLaunch L(BB * H * sh.cs, sh.cs, 32 * sh.warps, smem, st);
  e = cudaLaunchKernelEx(&L.cfg, self_split_kernel<T>, (const T*)q, (const T*)kT,
                         (const T*)v, (T*)out, S, n, tiles);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// The ragged form is sized on all S positions: the host reads no index.
template <typename T>
cudaError_t launch_self_split_rows(const void* q, const void* kT, const void* v,
                                   const void* rows, void* out, int BB, int H, int S,
                                   cudaStream_t st) {
  using namespace split;
  const int tiles = (S + SELF_TILE - 1) / SELF_TILE;
  const SelfShape sh = self_shape(tiles);
  const size_t smem = self_smem(sh.warps, sh.cs * sh.warps);
  static SmemRaised raised;
  cudaError_t e = allow_smem(self_split_rows_kernel<T>, smem, raised);
  if (e != cudaSuccess) return e;
  ClusterLaunch L(BB * H * sh.cs, sh.cs, 32 * sh.warps, smem, st);
  e = cudaLaunchKernelEx(&L.cfg, self_split_rows_kernel<T>, (const T*)q, (const T*)kT,
                         (const T*)v, (const int32_t*)rows, (T*)out, H, S, tiles);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <typename T>
cudaError_t launch_cross_split(const void* q, const void* kT, const void* v,
                               const void* bias, void* out, int B, int H, int S, int beam,
                               cudaStream_t st) {
  using namespace split;
  const int tiles = (S + CROSS_TILE - 1) / CROSS_TILE;
  const int cs = tiles < MAX_SPLIT ? tiles : MAX_SPLIT;
  ClusterLaunch L(B * H * cs, cs, 32, 0, st);
  const cudaError_t e =
      cudaLaunchKernelEx(&L.cfg, cross_split_kernel<T>, (const T*)q, (const T*)kT,
                         (const T*)v, (const float*)bias, (T*)out, H, S, beam, tiles);
  return e != cudaSuccess ? e : cudaGetLastError();
}

constexpr int ERR_VARIANT = 10001;  // split asked for fp32, or simt for bf16/fp16
constexpr int ERR_ALIGN = 10002;    // a split kernel's tensor not 16-byte aligned

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// ---- the int8 cache ----------------------------------------------------
// simt (fp32): one block per (row, head), two passes
namespace i8 {

constexpr float QK_SCALE = 0.125f;  // DH^-1/2, exact for DH = 64

// One query (64 values at q) against n positions of one (row, head)'s int8
// K^T (Dh, S: row stride S) and V (S, Dh) with their scales, plus the
// additive bias bp[0..n) (null: none); the 64 outputs go to out.
template <typename T>
__device__ __forceinline__ void attend(const T* __restrict__ q, const int8_t* __restrict__ kp,
                                       const int8_t* __restrict__ vp,
                                       const float* __restrict__ ksp,
                                       const float* __restrict__ vsp,
                                       const float* __restrict__ bp, T* __restrict__ out,
                                       int S, int n) {
  extern __shared__ float sc[];  // [S] scores, then weights
  __shared__ float qs[DH];
  __shared__ float red[WARPS];
  __shared__ float part[THREADS];
  if (threadIdx.x < DH) qs[threadIdx.x] = to_f(q[threadIdx.x]);
  __syncthreads();
  for (int s = threadIdx.x; s < n; s += THREADS) {
    float acc = 0.f;
#pragma unroll 16
    for (int d = 0; d < DH; ++d) acc += qs[d] * (float)kp[(size_t)d * S + s];
    const float l = acc * (ksp[s] * QK_SCALE);
    sc[s] = bp == nullptr ? l : l + bp[s];
  }
  __syncthreads();
  block_softmax(sc, n, red);
  for (int s = threadIdx.x; s < n; s += THREADS) sc[s] = to_f(from_f<T>(sc[s] * vsp[s]));
  __syncthreads();
  const int d = threadIdx.x % DH;
  const int g = threadIdx.x / DH;
  float acc = 0.f;
#pragma unroll 8  // eight V loads in flight, the sum in position order
  for (int s = g; s < n; s += GROUPS) acc += sc[s] * (float)vp[(size_t)s * DH + d];
  part[threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.x < DH) {
    float o = 0.f;
    for (int i = 0; i < GROUPS; ++i) o += part[i * DH + d];
    out[d] = from_f<T>(o);
  }
}

// Self, one block per (row, head): positions 0..idx.
template <typename T>
__global__ void __launch_bounds__(THREADS)
self_i8_kernel(const T* __restrict__ q, const int8_t* __restrict__ kT,
               const int8_t* __restrict__ v, const float* __restrict__ ks,
               const float* __restrict__ vs, T* __restrict__ out, int S, int idx) {
  const size_t bh = blockIdx.x;  // row * H + head
  attend<T>(q + bh * DH, kT + bh * DH * S, v + bh * S * DH, ks + bh * S, vs + bh * S,
            nullptr, out + bh * DH, S, idx + 1);
}

// The ragged form: row r reads its own positions, from rows[r].
template <typename T>
__global__ void __launch_bounds__(THREADS)
self_i8_rows_kernel(const T* __restrict__ q, const int8_t* __restrict__ kT,
                    const int8_t* __restrict__ v, const float* __restrict__ ks,
                    const float* __restrict__ vs, const int32_t* __restrict__ rows,
                    T* __restrict__ out, int H, int S) {
  const size_t bh = blockIdx.x;
  attend<T>(q + bh * DH, kT + bh * DH * S, v + bh * S * DH, ks + bh * S, vs + bh * S,
            nullptr, out + bh * DH, S, row_positions(rows, (int)(bh / H), S));
}

// Cross, one block per (query row, head): query row r = b * beam + j reads
// utterance b's K^T / V (read once from device memory, again by the other
// beam queries from L2), all S positions, with bias (B, S) or null.
template <typename T>
__global__ void __launch_bounds__(THREADS)
cross_i8_kernel(const T* __restrict__ q, const int8_t* __restrict__ kT,
                const int8_t* __restrict__ v, const float* __restrict__ ks,
                const float* __restrict__ vs, const float* __restrict__ bias,
                T* __restrict__ out, int H, int S, int beam) {
  const size_t rh = blockIdx.x;  // query row * H + head
  const int b = (int)(rh / H) / beam, h = (int)(rh % H);
  const size_t bh = (size_t)b * H + h;
  attend<T>(q + rh * DH, kT + bh * DH * S, v + bh * S * DH, ks + bh * S, vs + bh * S,
            bias == nullptr ? nullptr : bias + (size_t)b * S, out + rh * DH, S, S);
}

template <typename T>
cudaError_t launch_self(const void* q, const void* kT, const void* v, const void* ks,
                        const void* vs, void* out, int BB, int H, int S, int idx,
                        cudaStream_t st) {
  const size_t smem = (size_t)S * sizeof(float);
  static SmemRaised raised;
  cudaError_t e = allow_smem(self_i8_kernel<T>, smem, raised);
  if (e != cudaSuccess) return e;
  self_i8_kernel<T><<<BB * H, THREADS, smem, st>>>(
      (const T*)q, (const int8_t*)kT, (const int8_t*)v, (const float*)ks,
      (const float*)vs, (T*)out, S, idx);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_self_rows(const void* q, const void* kT, const void* v, const void* ks,
                             const void* vs, const void* rows, void* out, int BB, int H,
                             int S, cudaStream_t st) {
  const size_t smem = (size_t)S * sizeof(float);
  static SmemRaised raised;
  cudaError_t e = allow_smem(self_i8_rows_kernel<T>, smem, raised);
  if (e != cudaSuccess) return e;
  self_i8_rows_kernel<T><<<BB * H, THREADS, smem, st>>>(
      (const T*)q, (const int8_t*)kT, (const int8_t*)v, (const float*)ks,
      (const float*)vs, (const int32_t*)rows, (T*)out, H, S);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_cross(const void* q, const void* kT, const void* v, const void* ks,
                         const void* vs, const void* bias, void* out, int B, int H,
                         int S, int beam, cudaStream_t st) {
  const size_t smem = (size_t)S * sizeof(float);
  static SmemRaised raised;
  cudaError_t e = allow_smem(cross_i8_kernel<T>, smem, raised);
  if (e != cudaSuccess) return e;
  cross_i8_kernel<T><<<B * beam * H, THREADS, smem, st>>>(
      (const T*)q, (const int8_t*)kT, (const int8_t*)v, (const float*)ks,
      (const float*)vs, (const float*)bias, (T*)out, H, S, beam);
  return cudaGetLastError();
}

// I8_MARK(k): a probe build (-DSTAC_I8_TRACE) records the global timer at
// point k of each block (thread 0) into i8_trace[block * 8 + k]; empty in
// the library.
#ifdef STAC_I8_TRACE
__device__ unsigned long long* i8_trace;
#define I8_MARK(k)                                                         \
  do {                                                                     \
    if (threadIdx.x == 0 && i8_trace != nullptr) {                         \
      unsigned long long t_;                                               \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));              \
      i8_trace[blockIdx.x * 8 + (k)] = t_;                                 \
    }                                                                      \
  } while (0)
#else
#define I8_MARK(k)
#endif

// ---- split (bf16 / fp16): position tiles over the warps of a cluster --------
// A unit is one warp; unit u = rank * warps + warp of the cluster takes the
// contiguous tiles [u * tiles / units, (u + 1) * tiles / units). A warp
// copies its tiles' K^T rows, V rows and scales straight into its shared
// memory (cp.async), so no register holds a load and many warps fit an SM.
constexpr int TILE = 32;        // positions per tile
constexpr int KW = TILE + 8;    // bytes of a staged K^T row: 5 aligned 8-byte chunks
constexpr int SW = TILE + 4;    // floats of a staged scale window: 9 aligned chunks
constexpr int MAX_WARPS = 4;    // warps per block, at most (cross)
constexpr int SELF_WARPS = 8;   // warps per block, at most (self)
// registers a thread (self): five blocks of four warps an SM, every block of
// the 160-row case resident at once
constexpr int SELF_REGS = 96;
constexpr int KT_BYTES = DH * KW;        // a tile's K^T rows, as read
constexpr int V_BYTES = TILE * DH;       // a tile's V rows, int8
constexpr int SW_BYTES = SW * 4;         // a scale window
constexpr float MAGIC = 8388736.f;       // 2^23 + 128

// int8 x from its byte u (zero-extended): the float 2^23 + 128 + x, less
// 2^23 + 128 (exact, two ALU operations, no conversion unit).
__device__ __forceinline__ float i8_byte(uint32_t u) {
  return __int_as_float(u ^ 0x4B000080u) - MAGIC;
}
// Byte i of a word of four int8 already xor-ed with 0x80808080.
__device__ __forceinline__ float i8_of(uint32_t wx, int i) {
  return __int_as_float(__byte_perm(wx, 0x4B00u, 0x5440u | i)) - MAGIC;
}

// 16 bytes from p to shared memory at s, asynchronously; zeros when !ok
// (nothing is read: the source then names `safe`, a valid address).
__device__ __forceinline__ void cp16(void* s, const void* p, bool ok, const void* safe) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(s))),
               "l"(ok ? p : safe), "r"(ok ? 16 : 0)
               : "memory");
}
// 8 bytes, as cp16 (through L1: the 16-byte form bypasses it).
__device__ __forceinline__ void cp8(void* s, const void* p, bool ok, const void* safe) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(s))),
               "l"(ok ? p : safe), "r"(ok ? 8 : 0)
               : "memory");
}

// The K^T rows of positions [p0, pend) of one (row, head)'s slab kp (Dh x S,
// row stride S, 16-byte aligned) into kt: for each head dim d, the five
// aligned 8-byte chunks from floor8(d*S + p0) (a chunk holding none of the
// row's bytes is zeros, not read). As p0 is a multiple of 32, position
// p0 + p of dim d then sits at byte d*KW + ((d*S) & 7) + p of kt.
__device__ __forceinline__ void copy_k(uint8_t* kt, const int8_t* kp, int S, int p0, int pend,
                                       int lane) {
#pragma unroll
  for (int i = 0; i < DH * 5 / 32; ++i) {
    const int idx = lane + 32 * i, d = idx / 5, c = idx % 5;
    const int a = ((d * S + p0) & ~7) + 8 * c;
    cp8(kt + d * KW + 8 * c, kp + a, a < d * S + pend, kp);
  }
}
// The V rows of positions [p0, pend) (the rest zeros, not read), 64 bytes
// each, into vt: lane takes chunk lane & 3 of rows (lane >> 2) + 8i.
__device__ __forceinline__ void copy_v(uint8_t* vt, const int8_t* vp, int p0, int pend,
                                       int lane) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = (lane >> 2) + 8 * i, c = 16 * (lane & 3);
    cp16(vt + r * DH + c, vp + (size_t)(p0 + r) * DH + c, p0 + r < pend, vp);
  }
}
// Chunk `lane` (< 9) of the scale window of positions [p0, pend) of the
// scale row starting at element `row` of s (16-byte aligned) into sw:
// position p0 + p then sits at sw[((row + p0) & 3) + p].
__device__ __forceinline__ void copy_scales(float* sw, const float* s, size_t row, int p0,
                                            int pend, int lane) {
  if (lane >= SW / 4) return;
  const size_t a = ((row + p0) & ~(size_t)3) + 4 * lane;
  cp16(sw + 4 * lane, s + a, a < row + pend, s);
}

// 16 int8 (one 16-byte chunk) as two 16-byte chunks of T.
template <typename T>
__device__ __forceinline__ void i8x16_to(const uint4& x, uint4& lo, uint4& hi) {
  const uint32_t w[4] = {x.x ^ 0x80808080u, x.y ^ 0x80808080u, x.z ^ 0x80808080u,
                         x.w ^ 0x80808080u};
  uint32_t r[8];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    r[2 * k] = split::pack2<T>(i8_of(w[k], 0), i8_of(w[k], 1));
    r[2 * k + 1] = split::pack2<T>(i8_of(w[k], 2), i8_of(w[k], 3));
  }
  lo = make_uint4(r[0], r[1], r[2], r[3]);
  hi = make_uint4(r[4], r[5], r[6], r[7]);
}

// The launch shape of a split int8 kernel: a cluster of `cs` blocks of
// `warps` warps per (row, head) -- per (utterance, head) for cross.
struct Shape {
  int cs, warps;
};
constexpr int STAGES = 2;  // tiles a warp has in flight
// From the tiles of one (row, head) and the (row, head)s of the launch: a
// unit (warp) per tile while the launch has few tiles in all, else a unit
// per STAGES tiles (fewer, fuller warps, every block resident at once), as
// far as 8 blocks of `max_warps` allow.
Shape split_shape(int tiles, int heads, int max_warps) {
  const int per = (size_t)tiles * heads > 1024 ? STAGES : 1;
  const int units = (tiles + per - 1) / per;
  const int warps = units < max_warps ? units : max_warps;
  const int cs = (units + warps - 1) / warps;
  return {cs < split::MAX_SPLIT ? cs : split::MAX_SPLIT, warps};
}
// Cross: a warp with two tiles holds ~18 KB of shared memory, so such
// units go two to a block (four left the 801-frame slot loop a second wave
// of blocks; tools/probe_int8_split.py).
Shape cross_shape(int tiles, int heads) {
  return split_shape(tiles, heads, (size_t)tiles * heads > 1024 ? 2 : MAX_WARPS);
}
int slots_of(int tiles, Shape sh) {  // tiles of the busiest unit
  const int units = sh.cs * sh.warps;
  return (tiles + units - 1) / units;
}

// A stage: one tile's K^T rows and V rows as read, and its two scale
// windows.
constexpr int STAGE_BYTES = KT_BYTES + V_BYTES + 2 * SW_BYTES;
struct Stage {
  uint8_t* k;
  uint8_t* v;
  float* ks;
  float* vs;
  __device__ Stage(unsigned char* base, int j) {
    k = base + j * STAGE_BYTES;
    v = k + KT_BYTES;
    ks = reinterpret_cast<float*>(v + V_BYTES);
    vs = ks + SW;
  }
};

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most n (0 or 1) of this thread's copy groups are pending,
// then for the warp.
__device__ __forceinline__ void cp_wait(int n) {
  if (n > 0)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncwarp();
}

// A cluster of one block synchronises with the block's barrier and keeps to
// its own shared memory (a cluster barrier costs microseconds).
__device__ __forceinline__ void cluster_start(int cs) {
  if (cs > 1) split::cluster_arrive_relaxed();
}
__device__ __forceinline__ void cluster_started(int cs) {  // before the first send
  if (cs > 1) split::cluster_wait();
}
__device__ __forceinline__ void cluster_sync(int cs) {  // release, then acquire
  if (cs > 1) {
    split::cluster_arrive();
    split::cluster_wait();
  } else {
    __syncthreads();
  }
}
template <typename U>
__device__ __forceinline__ U* at_rank(U* p, int rank, int cs) {
  return cs > 1 ? split::peer(p, rank) : p;
}

// ---- decode_cross_attention_int8, split ---------------------------------
// Dynamic shared memory: the inbox [cs][own][Dh] of the rows this block
// owns, the (max, sum) of every unit and row [units][16] and the bias row;
// then per warp STAGES stages, a 4 KB buffer (the V tile in T, then the
// warp's partial output) and the logits of its `slots` tiles (16 x 32 each).
constexpr int TV_BYTES = MAX_BEAM * DH * 4;
__host__ __device__ inline size_t cross_head_bytes(int cs, int own, int units, int S,
                                                   bool bias) {
  return (size_t)cs * own * DH * 4 + (size_t)units * MAX_BEAM * 8 +
         (bias ? ((size_t)S / 4 + 2) * 16 : 0);
}
__host__ __device__ inline size_t cross_warp_bytes(int slots) {
  return STAGES * STAGE_BYTES + TV_BYTES + (size_t)slots * MAX_BEAM * TILE * 4;
}

// One (utterance, head) split over `tiles` = ceil(S / TILE) position tiles,
// all beam queries the 16 rows of mma.sync (zero past beam), so each int8
// key and value is read from device memory once per utterance.
//  1. With a bias, the block reads the utterance's bias row (4 bytes a
//     position) first. If some position's bias is > NEG_INF / 2, a tile
//     whose every bias is <= NEG_INF is skipped: no K/V read, no work. Its
//     logits would lie >= 5e8 below the row's max, where expf is exactly 0,
//     so the sums are the reference's either way. A row with no such
//     position reads every tile (the reference's softmax is then uniform).
//  2. A warp copies the K^T rows and k_scale of up to STAGES tiles at once
//     (a copy group per tile) and scores each tile as its keys land: B
//     fragments converted from the staged K^T bytes; logit = (q . k)_fp32 *
//     (k_scale * Dh^-1/2) + bias, kept in shared memory with the unit's row
//     maxima and sums of exp(l - max). Then it copies that tile's V rows
//     and v_scale, which land while the cluster exchanges its statistics.
//  3. Every unit sends its (max, sum) per row to every block (distributed
//     shared memory); after one cluster barrier each takes the row's max M
//     and sum L = sum_u l_u * exp(m_u - M), in unit order.
//  4. Per tile: w_p = exp(l_p - M) / L * v_scale_p rounded to T, as the
//     reference rounds it; O += W V on mma.sync with V converted into a
//     swizzled tile (ldmatrix.trans).
//  5. The warps' partials are summed in the block in warp order, sent to the
//     row's owner block, and summed there in rank order after a second
//     barrier. No global scratch, no atomics: bitwise repeatable.
template <typename T>
__global__ void __launch_bounds__(32 * MAX_WARPS, 3)
cross_i8_split_kernel(const T* __restrict__ q, const int8_t* __restrict__ kT,
                      const int8_t* __restrict__ v, const float* __restrict__ ks,
                      const float* __restrict__ vs, const float* __restrict__ bias,
                      T* __restrict__ out, int H, int S, int beam, int tiles, int slots) {
  using namespace split;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int cs = cluster_size(), rank = cluster_rank();
  cluster_start(cs);
  I8_MARK(0);
  const int W = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int units = cs * W, u = rank * W + warp;
  const int bh = blockIdx.x / cs, b = bh / H, h = bh % H;
  const int g = lane >> 2, qd = lane & 3;  // fragment row group, thread in quad
  const int own = (beam + cs - 1) / cs;
  const int t0 = u * tiles / units, t1 = (u + 1) * tiles / units;
  float* inbox = reinterpret_cast<float*>(smem_raw);
  float2* stats = reinterpret_cast<float2*>(inbox + cs * own * DH);
  float* brow = reinterpret_cast<float*>(stats + units * MAX_BEAM);
  auto warp_base = [&](int w) {
    return smem_raw + cross_head_bytes(cs, own, units, S, bias != nullptr) +
           w * cross_warp_bytes(slots);
  };
  unsigned char* mine = warp_base(warp);
  unsigned char* tv_raw = mine + STAGES * STAGE_BYTES;  // the V tile, then the partial
  float* lg = reinterpret_cast<float*>(tv_raw + TV_BYTES);
  const int8_t* kp = kT + (size_t)bh * DH * S;
  const int8_t* vp = v + (size_t)bh * S * DH;
  const size_t srow = (size_t)bh * S;

  // Q as the A operand: rows are the beam queries, zero past beam
  uint32_t qa[4][4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = g + (e & 1) * 8, dim = k * 16 + qd * 2 + (e >> 1) * 8;
      qa[k][e] = row < beam ? *reinterpret_cast<const uint32_t*>(
                                  q + (((size_t)b * beam + row) * H + h) * DH + dim)
                            : 0u;
    }

  // 1. the bias row, as aligned 16-byte chunks: position p at brow[boff + p]
  bool skip = false;
  int boff = 0;
  if (bias != nullptr) {
    const size_t e0 = (size_t)b * S;
    boff = (int)(e0 & 3);
    const float4* src = reinterpret_cast<const float4*>(bias + (e0 - boff));
    bool vis = false;
    for (int c = threadIdx.x; c < (boff + S + 3) / 4; c += blockDim.x) {
      const float4 x = __ldg(src + c);
      reinterpret_cast<float4*>(brow)[c] = x;
      const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int p = 4 * c + k - boff;
        vis |= p >= 0 && p < S && xs[k] > 0.5f * NEG_INF;
      }
    }
    skip = __syncthreads_or(vis);
    I8_MARK(1);
  }
  auto masked = [&](int t) {  // warp-uniform: tile t is skipped
    const int p = t * TILE + lane;
    return skip && __all_sync(0xffffffffu, p >= S || brow[boff + p] <= NEG_INF);
  };
  auto copy_v_of = [&](const Stage& st, int t) {
    const int p0 = t * TILE, pend = min(p0 + TILE, S);
    copy_v(st.v, vp, p0, pend, lane);
    copy_scales(st.vs, vs, srow, p0, pend, lane);
  };

  // 2. logits of this unit's tiles, STAGES at a time; the first ones' V
  // rows are copied with them and kept
  float mrow[2] = {-INFINITY, -INFINITY};  // rows g, g + 8
  int nv = -1;  // tiles whose V rows the first copies hold (stages 0..nv-1)
  for (int t = t0;;) {
    int gt[STAGES], c = 0;
    for (; t < t1 && c < STAGES; ++t)
      if (!masked(t)) gt[c++] = t;
    if (c == 0) break;
    __syncwarp();  // the previous tiles' reads of shared memory are done
#pragma unroll
    for (int j = 0; j < STAGES; ++j) {
      if (j >= c) break;
      const Stage st(mine, j);
      const int p0 = gt[j] * TILE, pend = min(p0 + TILE, S);
      copy_k(st.k, kp, S, p0, pend, lane);
      copy_scales(st.ks, ks, srow, p0, pend, lane);
      cp_commit();
    }
    const bool first = nv < 0;
    if (first) nv = c;
#pragma unroll
    for (int j = 0; j < STAGES; ++j) {
      if (j >= c) break;
      // tile gt[j]'s keys have landed (pending: the later tiles' keys and,
      // in the first group, the V rows of the tiles before it)
      cp_wait(c - 1 - j + (first ? j : 0));
      if (first && j == 0) I8_MARK(2);
      const Stage st(mine, j);
      const int p0 = gt[j] * TILE;
      float s[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        int at[4];  // dims d0, d0+1, d0+8, d0+9: where their row's tile starts
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int d = k * 16 + qd * 2 + (e & 1) + (e >> 1) * 8;
          at[e] = d * KW + ((d * S) & 7) + g;
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const uint32_t b0 =
              pack2<T>(i8_byte(st.k[at[0] + nt * 8]), i8_byte(st.k[at[1] + nt * 8]));
          const uint32_t b1 =
              pack2<T>(i8_byte(st.k[at[2] + nt * 8]), i8_byte(st.k[at[3] + nt * 8]));
          mma16816<T>(s[nt], qa[k], b0, b1);
        }
      }
      const int o4 = (int)((srow + p0) & 3);
      float4* keep = reinterpret_cast<float4*>(lg + (gt[j] - t0) * MAX_BEAM * TILE);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = nt * 8 + qd * 2 + (e & 1);
          float x = s[nt][e] * (st.ks[o4 + col] * QK_SCALE);
          if (bias != nullptr && p0 + col < S) x += brow[boff + p0 + col];
          s[nt][e] = p0 + col < S ? x : -INFINITY;  // a select: past S may be garbage
          mrow[e >> 1] = fmaxf(mrow[e >> 1], s[nt][e]);
        }
        keep[nt * 32 + lane] = make_float4(s[nt][0], s[nt][1], s[nt][2], s[nt][3]);
      }
      if (first) {  // its V rows, now: the keys of every tile go first
        copy_v_of(st, gt[j]);
        cp_commit();
      }
    }
  }
  float lrow[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mrow[r] = fmaxf(mrow[r], __shfl_xor_sync(0xffffffffu, mrow[r], 1));
    mrow[r] = fmaxf(mrow[r], __shfl_xor_sync(0xffffffffu, mrow[r], 2));
  }
  if (nv > 0) {
    for (int t = t0; t < t1; ++t) {
      if (masked(t)) continue;
      const float4* keep = reinterpret_cast<const float4*>(lg + (t - t0) * MAX_BEAM * TILE);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float4 x = keep[nt * 32 + lane];
        lrow[0] += __expf(x.x - mrow[0]) + __expf(x.y - mrow[0]);
        lrow[1] += __expf(x.z - mrow[1]) + __expf(x.w - mrow[1]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lrow[r] += __shfl_xor_sync(0xffffffffu, lrow[r], 1);
    lrow[r] += __shfl_xor_sync(0xffffffffu, lrow[r], 2);
  }

  // 3. (max, sum) of rows g, g + 8 to every block; a unit with no tile sends
  // (-inf, 0)
  I8_MARK(3);
  cluster_started(cs);
  for (int r = qd; r < cs; r += 4) {
    float2* dst = at_rank(stats, r, cs) + u * MAX_BEAM;
    dst[g] = make_float2(mrow[0], lrow[0]);
    dst[g + 8] = make_float2(mrow[1], lrow[1]);
  }
  cluster_sync(cs);  // every unit's statistics have arrived
  I8_MARK(4);
  float M[2], inv[2];  // the row's max and 1 / sum
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    M[r] = -INFINITY;
    for (int k = 0; k < units; ++k) M[r] = fmaxf(M[r], stats[k * MAX_BEAM + g + 8 * r].x);
    float L = 0.f;
    for (int k = 0; k < units; ++k) {  // in unit order
      const float2 x = stats[k * MAX_BEAM + g + 8 * r];
      if (x.x > -INFINITY) L += x.y * __expf(x.x - M[r]);
    }
    inv[r] = 1.f / L;
  }

  // 4. O = W V over this unit's tiles
  float o[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
  T* tvt = reinterpret_cast<T*>(tv_raw);  // the V tile, 16-byte chunks swizzled
  for (int t = t0, i = 0; t < t1; ++t) {
    if (masked(t)) continue;
    const int j = i % STAGES;  // the stage holding tile t's V rows
    const Stage st(mine, j);
    __syncwarp();  // the previous tile's reads of shared memory are done
    if (i >= nv) {  // past the first tiles: read now
      copy_v_of(st, t);
      cp_commit();
      cp_wait(0);
    } else {
      cp_wait(nv - 1 - i);  // its V rows have landed
    }
    ++i;
    const int p0 = t * TILE;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int r = (lane >> 2) + 8 * k, c = 2 * (lane & 3);
      uint4 lo, hi;
      i8x16_to<T>(*reinterpret_cast<const uint4*>(st.v + r * DH + 8 * c), lo, hi);
      *reinterpret_cast<uint4*>(&tvt[r * DH + 8 * (c ^ (r & 7))]) = lo;
      *reinterpret_cast<uint4*>(&tvt[r * DH + 8 * ((c + 1) ^ (r & 7))]) = hi;
    }
    __syncwarp();
    const int o4 = (int)((srow + p0) & 3);
    const float4* keep = reinterpret_cast<const float4*>(lg + (t - t0) * MAX_BEAM * TILE);
    float w[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const float4 x = keep[nt * 32 + lane];
      const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + qd * 2 + (e & 1);
        const float p = __expf(xs[e] - M[e >> 1]) * inv[e >> 1];
        w[nt][e] = p0 + col < S ? p * st.vs[o4 + col] : 0.f;  // a select: past S may be garbage
      }
    }
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t pa[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* pe = &w[2 * kk + (e >> 1)][(e & 1) * 2];
        pa[e] = pack2<T>(pe[0], pe[1]);  // w rounded to T, as the reference rounds it
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        const int mat = lane >> 3, row = lane & 7;
        const int pos = kk * 16 + (mat & 1) * 8 + row, chunk = 2 * np + (mat >> 1);
        uint32_t vb[4];
        ldsm_x4_trans(vb, &tvt[pos * DH + 8 * (chunk ^ (pos & 7))]);
        mma16816<T>(o[2 * np], pa, vb[0], vb[1]);
        mma16816<T>(o[2 * np + 1], pa, vb[2], vb[3]);
      }
    }
  }

  I8_MARK(5);
  // 5. the block's sum of its warps' partials, in warp order, to each row's
  // owner; the owner sums the blocks' in rank order
  __syncwarp();
  float* part = reinterpret_cast<float*>(tv_raw);  // rows x Dh, 8-float groups swizzled
  if (nv > 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int j = g + 8 * r;
      if (j >= beam) continue;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        *reinterpret_cast<float2*>(&part[j * DH + 8 * (nt ^ (j & 7)) + qd * 2]) =
            make_float2(o[nt][2 * r], o[nt][2 * r + 1]);
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < beam * (DH / 2); e += blockDim.x) {
    const int j = e / (DH / 2), d = (e % (DH / 2)) * 2;
    const int at = j * DH + 8 * ((d >> 3) ^ (j & 7)) + (d & 7);
    float2 acc = make_float2(0.f, 0.f);
    for (int w2 = 0; w2 < W; ++w2) {
      if (!(stats[(rank * W + w2) * MAX_BEAM + j].x > -INFINITY)) continue;  // no tile
      const float2 x = *reinterpret_cast<const float2*>(
          reinterpret_cast<const float*>(warp_base(w2) + STAGES * STAGE_BYTES) + at);
      acc.x += x.x;
      acc.y += x.y;
    }
    *reinterpret_cast<float2*>(at_rank(inbox, j % cs, cs) +
                               ((size_t)rank * own + j / cs) * DH + d) = acc;
  }
  cluster_sync(cs);  // every block's partials have arrived
  I8_MARK(6);
  for (int e = threadIdx.x; e < own * (DH / 2); e += blockDim.x) {
    const int lr = e / (DH / 2), d = (e % (DH / 2)) * 2;
    const int j = lr * cs + rank;
    if (j >= beam) continue;
    float o0 = 0.f, o1 = 0.f;
    for (int src = 0; src < cs; ++src) {  // in rank order: bitwise repeatable
      const float2 x = *reinterpret_cast<const float2*>(inbox + ((size_t)src * own + lr) * DH + d);
      o0 += x.x;
      o1 += x.y;
    }
    *reinterpret_cast<uint32_t*>(out + (((size_t)b * beam + j) * H + h) * DH + d) =
        pack2<T>(o0, o1);
  }
  I8_MARK(7);
}

// ---- decode_self_attention_int8, split ----------------------------------
// Dynamic shared memory: q in fp32, rank 0's inbox of the units' partial
// outputs [units][Dh] and every unit's (max, sum) [units]; then per warp
// STAGES stages and the scores of its `slots` tiles.
__host__ __device__ inline size_t self_head_bytes(int units) {
  return DH * 4 + (size_t)units * DH * 4 + ((size_t)units * 8 + 15) / 16 * 16;
}
__host__ __device__ inline size_t self_warp_bytes(int slots) {
  return STAGES * STAGE_BYTES + (size_t)slots * TILE * 4;
}

// One query per (row, head), so the CUDA cores: lane p of a warp scores
// position p0 + p of its tile from the staged K^T rows (each byte read from
// shared memory and converted in two ALU operations), as soon as the
// tile's keys land; each lane then takes 16-byte chunks of four V rows,
// weighted by their positions' w (one shuffle each), and the 64 dims are
// summed over the lanes that hold them. The copies and the cross-cluster
// softmax are cross's (steps 2-4), with one (max, sum) per unit; the
// partials go to rank 0, summed in unit order. Positions p >= n score -inf
// (a select) and their V rows are never read. The ragged form (RAGGED) is
// launched on all S positions; each row reads its own
// min(rows[r], S - 1) + 1, and a unit whose tiles lie past them reads
// nothing and sends (-inf, 0).
template <typename T, bool RAGGED>
__device__ __forceinline__ void self_i8_split_body(
    const T* __restrict__ q, const int8_t* __restrict__ kT, const int8_t* __restrict__ v,
    const float* __restrict__ ks, const float* __restrict__ vs,
    const int32_t* __restrict__ rows, T* __restrict__ out, int H, int S, int n_all, int tiles,
    int slots) {
  using namespace split;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int cs = cluster_size(), rank = cluster_rank();
  cluster_start(cs);
  I8_MARK(0);
  const int W = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int units = cs * W, u = rank * W + warp;
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* inbox = qs + DH;
  float2* stats = reinterpret_cast<float2*>(inbox + units * DH);
  unsigned char* mine = smem_raw + self_head_bytes(units) + warp * self_warp_bytes(slots);
  float* sc = reinterpret_cast<float*>(mine + STAGES * STAGE_BYTES);
  const int bh = blockIdx.x / cs;  // row * H + head
  const int n = RAGGED ? row_positions(rows, bh / H, S) : n_all;
  const int t0 = u * tiles / units;
  const int t1 = RAGGED ? min((u + 1) * tiles / units, (n + TILE - 1) / TILE)
                        : (u + 1) * tiles / units;
  const int8_t* kp = kT + (size_t)bh * DH * S;
  const int8_t* vp = v + (size_t)bh * S * DH;
  const size_t srow = (size_t)bh * S;
  auto copy_v_of = [&](const Stage& st, int t) {
    const int p0 = t * TILE, pend = min(p0 + TILE, n);
    copy_v(st.v, vp, p0, pend, lane);
    copy_scales(st.vs, vs, srow, p0, pend, lane);
  };
  if (warp == 0) {  // the block's (row, head): q in fp32
    const float2 f = unpack2<T>(__ldg(reinterpret_cast<const uint32_t*>(q + (size_t)bh * DH) + lane));
    qs[2 * lane] = f.x;
    qs[2 * lane + 1] = f.y;
  }
  __syncthreads();

  // scores, STAGES tiles at a time, each as its keys land; then its V rows
  // byte offset of position `lane` in the staged row of dim d: off8[d & 7]
  // + d * KW ((d * S) & 7 repeats every 8 dims)
  int off8[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) off8[k] = ((k * S) & 7) + lane;
  float m = -INFINITY;
  for (int tg = t0; tg < t1; tg += STAGES) {
    const int c = min(STAGES, t1 - tg);
    __syncwarp();  // the previous tiles' reads of shared memory are done
#pragma unroll 1
    for (int j = 0; j < STAGES; ++j) {
      if (j >= c) break;
      const Stage st(mine, j);
      const int p0 = (tg + j) * TILE, pend = min(p0 + TILE, n);
      copy_k(st.k, kp, S, p0, pend, lane);
      copy_scales(st.ks, ks, srow, p0, pend, lane);
      cp_commit();
    }
    const bool first = tg == t0;
#pragma unroll 1
    for (int j = 0; j < STAGES; ++j) {
      if (j >= c) break;
      // tile tg + j's keys have landed (pending: the later tiles' keys and,
      // in the first group, the V rows of the tiles before it)
      cp_wait(c - 1 - j + (first ? j : 0));
      if (first && j == 0) I8_MARK(2);
      const Stage st(mine, j);
      const int p0 = (tg + j) * TILE, pend = min(p0 + TILE, n);
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int d4 = 0; d4 < DH / 4; ++d4) {
        const float4 qv = reinterpret_cast<const float4*>(qs)[d4];
        const float qq[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int d = 4 * d4 + k;
          acc[k] = fmaf(qq[k], i8_byte(st.k[d * KW + off8[d & 7]]), acc[k]);
        }
      }
      const int o4 = (int)((srow + p0) & 3);
      const float s =
          p0 + lane < pend
              ? ((acc[0] + acc[1]) + (acc[2] + acc[3])) * (st.ks[o4 + lane] * QK_SCALE)
              : -INFINITY;  // a select: stale bytes and scales never count
      sc[(tg + j - t0) * TILE + lane] = s;
      m = fmaxf(m, warp_max(s));  // finite: every tile has a position < n
      if (first) {  // its V rows, now: the keys of every tile go first
        copy_v_of(st, tg + j);
        cp_commit();
      }
    }
  }
  float l = 0.f;
  for (int t = t0; t < t1; ++t) l += __expf(sc[(t - t0) * TILE + lane] - m);
  l = warp_sum(l);

  I8_MARK(3);
  cluster_started(cs);
  if (lane < cs) at_rank(stats, lane, cs)[u] = make_float2(m, l);
  cluster_sync(cs);  // every unit's statistics have arrived
  I8_MARK(4);
  float M = -INFINITY, L = 0.f;
  for (int k = 0; k < units; ++k) M = fmaxf(M, stats[k].x);
  for (int k = 0; k < units; ++k) {  // in unit order
    const float2 x = stats[k];
    if (x.x > -INFINITY) L += x.y * __expf(x.x - M);
  }
  const float inv = 1.f / L;

  const int r0 = lane >> 2, c = lane & 3;  // V: rows r0 + 8i, bytes 16c..16c+15
  float o[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) o[k] = 0.f;
  const int nv = min(STAGES, t1 - t0);  // tiles whose V rows were copied
#pragma unroll 1
  for (int t = t0; t < t1; ++t) {
    const int p0 = t * TILE, pend = min(p0 + TILE, n);
    const Stage st(mine, (t - t0) % STAGES);
    if (t - t0 >= nv) {  // past the first tiles: read now
      __syncwarp();  // the previous tile's reads of shared memory are done
      copy_v_of(st, t);
      cp_commit();
      cp_wait(0);
    } else {
      cp_wait(nv - 1 - (t - t0));  // its V rows have landed
    }
    const int o4 = (int)((srow + p0) & 3);
    const float p = __expf(sc[(t - t0) * TILE + lane] - M) * inv;
    // w rounded to T, as the reference rounds it; a select past n
    const float w = p0 + lane < pend ? to_f(from_f<T>(p * st.vs[o4 + lane])) : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float wr = __shfl_sync(0xffffffffu, w, r0 + 8 * i);
      const uint4 x = *reinterpret_cast<const uint4*>(st.v + (r0 + 8 * i) * DH + 16 * c);
      const uint32_t ws[4] = {x.x ^ 0x80808080u, x.y ^ 0x80808080u, x.z ^ 0x80808080u,
                              x.w ^ 0x80808080u};
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int by = 0; by < 4; ++by)
          o[4 * k + by] = fmaf(wr, i8_of(ws[k], by), o[4 * k + by]);
    }
  }
  I8_MARK(5);
  // lanes c, c + 4, ..., c + 28 hold the same 16 dims
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    o[k] += __shfl_xor_sync(0xffffffffu, o[k], 4);
    o[k] += __shfl_xor_sync(0xffffffffu, o[k], 8);
    o[k] += __shfl_xor_sync(0xffffffffu, o[k], 16);
  }
  if (t0 < t1 && lane < 4) {
    float4* dst = reinterpret_cast<float4*>(at_rank(inbox, 0, cs) + u * DH + 16 * lane);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      dst[k] = make_float4(o[4 * k], o[4 * k + 1], o[4 * k + 2], o[4 * k + 3]);
  }
  cluster_sync(cs);  // every partial has arrived
  I8_MARK(6);
  if (rank != 0 || warp != 0) return;
  float o0 = 0.f, o1 = 0.f;
  for (int k = 0; k < units; ++k) {  // in unit order: bitwise repeatable
    if (!(stats[k].x > -INFINITY)) continue;  // a unit with no tile
    o0 += inbox[k * DH + 2 * lane];
    o1 += inbox[k * DH + 2 * lane + 1];
  }
  *reinterpret_cast<uint32_t*>(out + (size_t)bh * DH + 2 * lane) = pack2<T>(o0, o1);
  I8_MARK(7);
}

// The scalar form: positions 0..n-1 of every row.
template <typename T>
__global__ void __maxnreg__(SELF_REGS)
self_i8_split_kernel(const T* __restrict__ q, const int8_t* __restrict__ kT,
                     const int8_t* __restrict__ v, const float* __restrict__ ks,
                     const float* __restrict__ vs, T* __restrict__ out, int S, int n, int tiles,
                     int slots) {
  self_i8_split_body<T, false>(q, kT, v, ks, vs, nullptr, out, 0, S, n, tiles, slots);
}

// The ragged form, launched on all S positions: row r reads its own.
template <typename T>
__global__ void __maxnreg__(SELF_REGS)
self_i8_split_rows_kernel(const T* __restrict__ q, const int8_t* __restrict__ kT,
                          const int8_t* __restrict__ v, const float* __restrict__ ks,
                          const float* __restrict__ vs, const int32_t* __restrict__ rows,
                          T* __restrict__ out, int H, int S, int tiles, int slots) {
  self_i8_split_body<T, true>(q, kT, v, ks, vs, rows, out, H, S, S, tiles, slots);
}

size_t self_smem(Shape sh, int slots) {
  return self_head_bytes(sh.cs * sh.warps) + sh.warps * self_warp_bytes(slots);
}

template <typename T>
cudaError_t launch_self_split(const void* q, const void* kT, const void* v, const void* ks,
                              const void* vs, void* out, int BB, int H, int S, int idx,
                              Shape sh, cudaStream_t st) {
  const int n = idx + 1, tiles = (n + TILE - 1) / TILE, slots = slots_of(tiles, sh);
  const size_t smem = self_smem(sh, slots);
  static SmemRaised raised;
  cudaError_t e = allow_smem(self_i8_split_kernel<T>, smem, raised);
  if (e != cudaSuccess) return e;
  ClusterLaunch L(BB * H * sh.cs, sh.cs, 32 * sh.warps, smem, st);
  e = cudaLaunchKernelEx(&L.cfg, self_i8_split_kernel<T>, (const T*)q, (const int8_t*)kT,
                         (const int8_t*)v, (const float*)ks, (const float*)vs, (T*)out, S, n,
                         tiles, slots);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <typename T>
cudaError_t launch_self_split_rows(const void* q, const void* kT, const void* v, const void* ks,
                                   const void* vs, const void* rows, void* out, int BB, int H,
                                   int S, Shape sh, cudaStream_t st) {
  const int tiles = (S + TILE - 1) / TILE, slots = slots_of(tiles, sh);
  const size_t smem = self_smem(sh, slots);
  static SmemRaised raised;
  cudaError_t e = allow_smem(self_i8_split_rows_kernel<T>, smem, raised);
  if (e != cudaSuccess) return e;
  ClusterLaunch L(BB * H * sh.cs, sh.cs, 32 * sh.warps, smem, st);
  e = cudaLaunchKernelEx(&L.cfg, self_i8_split_rows_kernel<T>, (const T*)q, (const int8_t*)kT,
                         (const int8_t*)v, (const float*)ks, (const float*)vs,
                         (const int32_t*)rows, (T*)out, H, S, tiles, slots);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <typename T>
cudaError_t launch_cross_split(const void* q, const void* kT, const void* v, const void* ks,
                               const void* vs, const void* bias, void* out, int B, int H, int S,
                               int beam, Shape sh, cudaStream_t st) {
  const int tiles = (S + TILE - 1) / TILE, slots = slots_of(tiles, sh);
  const int own = (beam + sh.cs - 1) / sh.cs;
  const size_t smem = cross_head_bytes(sh.cs, own, sh.cs * sh.warps, S, bias != nullptr) +
                      sh.warps * cross_warp_bytes(slots);
  static SmemRaised raised;
  cudaError_t e = allow_smem(cross_i8_split_kernel<T>, smem, raised);
  if (e != cudaSuccess) return e;
  ClusterLaunch L(B * H * sh.cs, sh.cs, 32 * sh.warps, smem, st);
  e = cudaLaunchKernelEx(&L.cfg, cross_i8_split_kernel<T>, (const T*)q, (const int8_t*)kT,
                         (const int8_t*)v, (const float*)ks, (const float*)vs,
                         (const float*)bias, (T*)out, H, S, beam, tiles, slots);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace i8


}  // namespace

extern "C" {

int stac_decode_head_dim() { return DH; }
int stac_decode_max_beam() { return MAX_BEAM; }

const char* stac_cuda_error_string(int code) {
  if (code == ERR_VARIANT)
    return "the decode kernels run split for bf16 and fp16, simt for fp32";
  if (code == ERR_ALIGN) return "the split kernels need 16-byte aligned tensors";
  return cudaGetErrorString((cudaError_t)code);
}

// In each of the three entry points, split != 0 launches the split kernel
// (bf16 and fp16), split == 0 the two-pass one (fp32); any other pairing is
// ERR_VARIANT.
int stac_decode_self_attention(const void* q, const void* kT, const void* v, void* out,
                               int BB, int H, int S, int idx, int dtype, int split,
                               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (!split) {
    if (dtype != F32) return ERR_VARIANT;
    return launch_self<float>(q, kT, v, out, BB, H, S, idx, st);
  }
  if (dtype != BF16 && dtype != F16) return ERR_VARIANT;
  if (!aligned16(q) || !aligned16(kT) || !aligned16(v)) return ERR_ALIGN;
  const SelfShape sh = self_shape((idx + split::SELF_TILE) / split::SELF_TILE);
  return dtype == BF16
             ? launch_self_split<__nv_bfloat16>(q, kT, v, out, BB, H, S, idx, sh, st)
             : launch_self_split<__half>(q, kT, v, out, BB, H, S, idx, sh, st);
}

// The ragged form: idx_rows (BB,) int32 on the device, one index per row.
int stac_decode_self_attention_rows(const void* q, const void* kT, const void* v,
                                    const void* idx_rows, void* out, int BB, int H, int S,
                                    int dtype, int split, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (!split) {
    if (dtype != F32) return ERR_VARIANT;
    return launch_self_rows<float>(q, kT, v, idx_rows, out, BB, H, S, st);
  }
  if (dtype != BF16 && dtype != F16) return ERR_VARIANT;
  if (!aligned16(q) || !aligned16(kT) || !aligned16(v)) return ERR_ALIGN;
  return dtype == BF16
             ? launch_self_split_rows<__nv_bfloat16>(q, kT, v, idx_rows, out, BB, H, S, st)
             : launch_self_split_rows<__half>(q, kT, v, idx_rows, out, BB, H, S, st);
}

int stac_decode_self_attention_anc(const void* q, const void* k, const void* v,
                                   const void* anc, void* out, int BB, int H, int S,
                                   int beam, int idx, int dtype, int split, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (!split) {
    if (dtype != F32) return ERR_VARIANT;
    return launch_anc<float>(q, k, v, anc, out, BB, H, S, beam, idx, st);
  }
  if (dtype != BF16 && dtype != F16) return ERR_VARIANT;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v)) return ERR_ALIGN;
  return dtype == BF16
             ? launch_anc_split<__nv_bfloat16>(q, k, v, anc, out, BB, H, S, beam, idx, st)
             : launch_anc_split<__half>(q, k, v, anc, out, BB, H, S, beam, idx, st);
}

int stac_decode_cross_attention(const void* q, const void* kT, const void* v,
                                const void* bias, void* out, int B, int H, int S,
                                int beam, int dtype, int split, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (!split) {
    if (dtype != F32) return ERR_VARIANT;
    return launch_cross<float>(q, kT, v, bias, out, B, H, S, beam, st);
  }
  if (dtype != BF16 && dtype != F16) return ERR_VARIANT;
  if (!aligned16(kT) || !aligned16(v)) return ERR_ALIGN;
  return dtype == BF16
             ? launch_cross_split<__nv_bfloat16>(q, kT, v, bias, out, B, H, S, beam, st)
             : launch_cross_split<__half>(q, kT, v, bias, out, B, H, S, beam, st);
}

// The int8 cache: idx a host int, or idx_rows (BB,) int32 on the device;
// k_scale / v_scale (rows, H, 1, S) fp32. split != 0 launches the split
// kernel (bf16 and fp16), split == 0 the two-pass one (fp32), as above.
int stac_decode_self_attention_int8(const void* q, const void* kT, const void* v,
                                    const void* k_scale, const void* v_scale, void* out,
                                    int BB, int H, int S, int idx, int dtype, int split,
                                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (!split) {
    if (dtype != F32) return ERR_VARIANT;
    return i8::launch_self<float>(q, kT, v, k_scale, v_scale, out, BB, H, S, idx, st);
  }
  if (dtype != BF16 && dtype != F16) return ERR_VARIANT;
  if (!aligned16(kT) || !aligned16(v) || !aligned16(k_scale) || !aligned16(v_scale))
    return ERR_ALIGN;
  const i8::Shape sh = i8::split_shape((idx + i8::TILE) / i8::TILE, BB * H, i8::SELF_WARPS);
  return dtype == BF16 ? i8::launch_self_split<__nv_bfloat16>(q, kT, v, k_scale, v_scale, out,
                                                               BB, H, S, idx, sh, st)
                       : i8::launch_self_split<__half>(q, kT, v, k_scale, v_scale, out, BB, H,
                                                       S, idx, sh, st);
}

int stac_decode_self_attention_int8_rows(const void* q, const void* kT, const void* v,
                                         const void* k_scale, const void* v_scale,
                                         const void* idx_rows, void* out, int BB, int H,
                                         int S, int dtype, int split, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (!split) {
    if (dtype != F32) return ERR_VARIANT;
    return i8::launch_self_rows<float>(q, kT, v, k_scale, v_scale, idx_rows, out, BB, H, S,
                                       st);
  }
  if (dtype != BF16 && dtype != F16) return ERR_VARIANT;
  if (!aligned16(kT) || !aligned16(v) || !aligned16(k_scale) || !aligned16(v_scale))
    return ERR_ALIGN;
  const i8::Shape sh = i8::split_shape((S + i8::TILE - 1) / i8::TILE, BB * H, i8::SELF_WARPS);
  return dtype == BF16
             ? i8::launch_self_split_rows<__nv_bfloat16>(q, kT, v, k_scale, v_scale, idx_rows,
                                                         out, BB, H, S, sh, st)
             : i8::launch_self_split_rows<__half>(q, kT, v, k_scale, v_scale, idx_rows, out,
                                                  BB, H, S, sh, st);
}

int stac_decode_cross_attention_int8(const void* q, const void* kT, const void* v,
                                     const void* k_scale, const void* v_scale,
                                     const void* bias, void* out, int B, int H, int S,
                                     int beam, int dtype, int split, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (!split) {
    if (dtype != F32) return ERR_VARIANT;
    return i8::launch_cross<float>(q, kT, v, k_scale, v_scale, bias, out, B, H, S, beam, st);
  }
  if (dtype != BF16 && dtype != F16) return ERR_VARIANT;
  if (!aligned16(kT) || !aligned16(v) || !aligned16(k_scale) || !aligned16(v_scale) ||
      (bias != nullptr && !aligned16(bias)))
    return ERR_ALIGN;
  const i8::Shape sh = i8::cross_shape((S + i8::TILE - 1) / i8::TILE, B * H);
  return dtype == BF16 ? i8::launch_cross_split<__nv_bfloat16>(q, kT, v, k_scale, v_scale, bias,
                                                                out, B, H, S, beam, sh, st)
                       : i8::launch_cross_split<__half>(q, kT, v, k_scale, v_scale, bias, out,
                                                        B, H, S, beam, sh, st);
}

}  // extern "C"
