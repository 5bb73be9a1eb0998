// Flash attention for Hopper (sm_90a): inference forward, training forward,
// and the two training backward kernels. One design, four kernels.
//
// Replaces the Pallas TPU kernels
//   flash_attention            <- stac_st_tpu/ops/pallas/attention.py:69 (_attn_kernel :35)
//   flash_attention_train fwd  <- stac_st_tpu/ops/pallas/train_attention.py:294 (_fwd_kernel :109)
//   flash_attention_train dQ   <- train_attention.py:344 (_dq_kernel :157)
//   flash_attention_train dK/dV<- train_attention.py:356 (_dkv_kernel :189)
//
// Semantics: softmax(scale * Q K^T + bias) V over q/k/v laid out (B, T, H, Dh)
// (row stride H*Dh, read in place: no transposes, no padding of T or Dh),
// an additive fp32 key-padding bias (B, Tk) or none, fp32 accumulation and
// stores in the input dtype. The training forward also writes the per-row
// logsumexp L (B*H, Tq) in fp32; the backward recomputes P = exp(S - L)
// instead of reading saved weights. Dropout on the attention weights runs
// inside the kernels: keep(i, j) is a murmur3-fmix32 hash of (seed, b*H + h
// with b the row in the global batch: the launch's rows start at bh0 / H,
// and the coordinates of (i, j) in the reference's logical tiling: one tile
// of ceil8(T) rows when that is <= 512, else 128-row tiles), so forward and
// backward regenerate the same mask and nothing is stored. The hash is the
// reference's counter path (_dropout_mask, train_attention.py:51-92), bit
// for bit; the tile sizes come from the wrapper.
//
// Bound: at the encoder training shape (B32 x 376 x 376, 4 heads of 64) the
// forward does 4.6 GFLOP against 24.6 MB of traffic, about 190 flop/byte,
// under the ~295 flop/byte ridge of the bf16 tensor cores, so the least
// time (7.4 us) is set by device memory; so it is for dQ (three products,
// 9.3 us) and dK/dV (four products, 11.2 us). Every kernel keeps its
// intermediates (scores, probabilities, dS) out of device memory and reads
// Q/K/V/dO once per block.
//
// Which kernel serves which call is fixed by dtype and head dim, one rule
// for all three training kernels (the wrapper's flash_variant names it in
// the use_tc argument of stac_flash_fwd, stac_flash_dq and stac_flash_dkv):
//
// * bf16 and fp16 at Dh 64 (every configuration of the repo: d256, 4 heads)
//   -> the tensor-core kernels, one warpgroup (128 threads) per 64 rows of
//   one (b, h); 64-row tiles arrive by TMA (4-D tensor maps over the
//   tensors' own (B, T, H, Dh) layout, 128-B swizzle, zero fill past T),
//   the streamed ones through a two-stage ring; every product is
//   wgmma.m64n64k16 over a depth of 64 with fp32 accumulators, either both
//   operands from shared memory (K-major) or A from registers (an
//   accumulator rounded to the input type) and B read through the
//   transpose bit; softmax, dropout hash and gradient arithmetic run on the
//   accumulators in registers.
//   - fwd_tc_kernel, both entry points' forward: S = Q K^T, O += P V over
//     streamed K/V tiles, online softmax. P is rounded to the input type
//     before P V (the reference keeps it in fp32).
//   - dq_tc_kernel: Q and dO resident, K/V streamed; S = Q K^T, dP = dO V^T,
//     dS = P o (dP o mask - delta) in registers, dQ += dS K.
//   - dkv_tc_kernel: K and V resident, Q/dO (and 64 values each of L and
//     delta) streamed; computed key-major from the start, so nothing is
//     transposed through shared memory: S^T = K Q^T, dP^T = V dO^T, then
//     dV += (P^T o mask) dO and dK += dS^T Q.
//   P and dS are rounded to the input type before the gradient products.
// * fp32, and any other head dim -> fwd_kernel, dq_kernel and dkv_kernel
//   on the fp32 CUDA cores: one fp32 train step is held to the CPU at rtol
//   1e-5, which TF32 or bf16 tensor cores cannot meet. 4 warps per block,
//   8 query (or key) rows per warp, 32-key (or 32-query) tiles with one
//   lane per key, an odd row stride so lanes never share a bank.
//
// This is a dispatch, not a fallback: a launch of either that fails is an
// error returned to the caller. The dQ / dK-dV split is the reference's
// own: each block owns its output rows, so there are no cross-block
// reductions and no atomics, and the gradients are deterministic.
//
// Plain C interface, loaded with ctypes; every launcher returns the
// cudaError_t of its launch (0 = success) or one of the ERR_* codes below.
// Kernels run on the caller's stream, allocate nothing and never
// synchronise. libcuda's cuTensorMapEncodeTiled is reached through
// cudaGetDriverEntryPoint, so the library does not link libcuda.

#include <cuda.h>  // CUtensorMap and its enums only; libcuda is not linked
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS = 8;                    // rows a warp owns
constexpr int BLOCK_ROWS = WARPS * ROWS;   // rows a block owns
constexpr int TILE = 32;                   // streamed rows per tile, one per lane
constexpr int MAX_DH = 128;
constexpr int DPL = MAX_DH / 32;           // head dims per lane
constexpr float NEG_INF = -1e9f;           // the reference's additive mask value

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

// Dropout parameters: keep iff hash >= thresh, kept values scaled by inv_keep.
struct Drop {
  uint32_t seed;
  uint32_t thresh;
  float inv_keep;
  int q_tile;  // logical tiling of the reference (not this kernel's tiles)
  int k_tile;
  int on;
  uint32_t bh0;  // b0 * H: the launch's first row b0 in the global batch
};

// The hash's terms: x = (seed*C0 ^ (bh+1)*C1 ^ (qt+1)*C2 ^ (kt+1)*C3)
// + row*C4 + col*C5, then murmur3's fmix32; kept iff x >= thresh.
constexpr uint32_t H_SEED = 0x9E3779B1u, H_BH = 0x85EBCA6Bu, H_QT = 0xC2B2AE35u,
                   H_KT = 0x27D4EB2Fu, H_ROW = 0x01000193u, H_COL = 0x0000F1A7u;

__device__ __forceinline__ bool kept(const Drop& dr, uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x >= dr.thresh;
}

// keep(i, j) / (1 - p) for query row i, key j of head bh.
__device__ __forceinline__ float keep_scale(const Drop& dr, uint32_t bh, int i, int j) {
  const uint32_t qt = (uint32_t)(i / dr.q_tile), row = (uint32_t)(i % dr.q_tile);
  const uint32_t kt = (uint32_t)(j / dr.k_tile), col = (uint32_t)(j % dr.k_tile);
  const uint32_t x = (dr.seed * H_SEED) ^ ((bh + dr.bh0 + 1u) * H_BH) ^ ((qt + 1u) * H_QT) ^
                     ((kt + 1u) * H_KT);
  return kept(dr, x + row * H_ROW + col * H_COL) ? dr.inv_keep : 0.f;
}

// rows [r0, r0 + n) of one head of a (B, T, H, Dh) tensor into smem
// (fp32, row stride ld), zeros past T
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* base, size_t rs,
                                          int r0, int n, int Tlen, int Dh, float mul) {
  for (int e = threadIdx.x; e < n * Dh; e += THREADS) {
    const int r = e / Dh, d = e % Dh, t = r0 + r;
    dst[r * ld + d] = t < Tlen ? to_f(base[(size_t)t * rs + d]) * mul : 0.f;
  }
}

// ---- forward: one block per (b*H + h, 32 query rows); streams key tiles ---
// WITH_L: training forward (writes L, may drop); else the inference kernel.
template <typename T, bool WITH_L>
__global__ void __launch_bounds__(THREADS)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const float* __restrict__ bias, T* __restrict__ out, float* __restrict__ lse,
           int H, int Tq, int Tk, int Dh, float scale, Drop dr) {
  extern __shared__ float smem[];
  const int ld = Dh + 1;  // odd: lane j reading row j hits bank (j*ld + d) % 32
  float* ks = smem;                    // [TILE][ld]
  float* vs = ks + TILE * ld;          // [TILE][ld]
  float* qs = vs + TILE * ld;          // [BLOCK_ROWS][Dh], scaled
  float* ps = qs + BLOCK_ROWS * Dh;    // [WARPS][ROWS][TILE] probabilities
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = blockIdx.y * BLOCK_ROWS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t rs = (size_t)H * Dh;
  const T* qb = q + (size_t)b * Tq * rs + (size_t)h * Dh;
  const T* kb = k + (size_t)b * Tk * rs + (size_t)h * Dh;
  const T* vb = v + (size_t)b * Tk * rs + (size_t)h * Dh;
  const float* biasb = bias == nullptr ? nullptr : bias + (size_t)b * Tk;
  load_rows(qs, Dh, qb, rs, q0, BLOCK_ROWS, Tq, Dh, scale);

  float m[ROWS], l[ROWS], o[ROWS][DPL];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) o[r][c] = 0.f;
  }
  const float* qw = qs + warp * ROWS * Dh;
  float* pw = ps + warp * ROWS * TILE;
  const int n_tiles = (Tk + TILE - 1) / TILE;
  for (int t = 0; t < n_tiles; ++t) {
    __syncthreads();  // the previous tile is consumed (and qs is written)
    load_rows(ks, ld, kb, rs, t * TILE, TILE, Tk, Dh, 1.f);
    load_rows(vs, ld, vb, rs, t * TILE, TILE, Tk, Dh, 1.f);
    __syncthreads();
    const int key = t * TILE + lane;
    const bool kin = key < Tk;
    const float add = (kin && biasb != nullptr) ? biasb[key] : 0.f;
    float s[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r] = 0.f;
    for (int d = 0; d < Dh; ++d) {
      const float kd = ks[lane * ld + d];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) s[r] += qw[r * Dh + d] * kd;
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float sr = kin ? s[r] + add : -INFINITY;
      const float m_new = fmaxf(m[r], warp_max(sr));
      float p = expf(sr - m_new);
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + warp_sum(p);  // normaliser before dropout
      m[r] = m_new;
      if (WITH_L && dr.on) p *= keep_scale(dr, (uint32_t)bh, q0 + warp * ROWS + r, key);
      pw[r * TILE + lane] = p;
#pragma unroll
      for (int c = 0; c < DPL; ++c) o[r][c] *= corr;
    }
    __syncwarp();
    const int nk = min(TILE, Tk - t * TILE);
    for (int j = 0; j < nk; ++j) {
#pragma unroll
      for (int c = 0; c < DPL; ++c) {
        const int d = lane + 32 * c;
        if (d < Dh) {
          const float vd = vs[j * ld + d];
#pragma unroll
          for (int r = 0; r < ROWS; ++r) o[r][c] += pw[r * TILE + j] * vd;
        }
      }
    }
    __syncwarp();
  }
  T* ob = out + (size_t)b * Tq * rs + (size_t)h * Dh;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int i = q0 + warp * ROWS + r;
    if (i >= Tq) continue;
    const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < DPL; ++c) {
      const int d = lane + 32 * c;
      if (d < Dh) ob[(size_t)i * rs + d] = from_f<T>(o[r][c] / den);
    }
    if (WITH_L && lane == 0)
      lse[(size_t)bh * Tq + i] = l[r] > 0.f ? m[r] + logf(den) : NEG_INF;
  }
}

// ---- forward on the tensor cores: bf16 / fp16, Dh 64 ----------------------
// One warpgroup (128 threads) per (b*H + h, 64 query rows). Thread 0 keeps
// the TMA load of K/V tile t+1 in flight while the warpgroup computes tile
// t (a ring of two stages; 42 KB, so four blocks share an SM). Every tile is
// 64 rows of 128 B, swizzled by TMA in 128-B rows, which is the layout the
// wgmma descriptors below name.
namespace tc {

constexpr int DH = 64;
constexpr int THREADS = 128;                         // one warpgroup
constexpr int ROWS = 64;                             // query rows per block
constexpr int KEYS = 64;                             // keys per tile
constexpr uint32_t TILE_BYTES = KEYS * DH * 2;       // 8 KB: a Q, K or V tile
constexpr uint32_t SQ = 0;                           // Q
constexpr uint32_t SK = TILE_BYTES;                  // K, two stages
constexpr uint32_t SV = 3 * TILE_BYTES;              // V, two stages
constexpr uint32_t SBAR = 5 * TILE_BYTES;            // an mbarrier a stage
constexpr size_t SMEM = SBAR + 16 + 1024;            // + room to align to 1 KB
static_assert(SMEM <= 48 * 1024, "fits the default dynamic shared-memory cap");
// The backward kernels: two resident tiles (dQ: Q, dO; dK/dV: K, V) and a
// two-stage ring of two streamed tiles (dQ: K, V; dK/dV: Q, dO). 50 KB,
// above the default cap: the launchers raise it.
constexpr uint32_t BA = 0;                           // resident A
constexpr uint32_t BB = TILE_BYTES;                  // resident B
constexpr uint32_t BR0 = 2 * TILE_BYTES;             // streamed 0, two stages
constexpr uint32_t BR1 = 4 * TILE_BYTES;             // streamed 1, two stages
constexpr uint32_t BBAR = 6 * TILE_BYTES;            // an mbarrier a stage
constexpr size_t BWD_SMEM = BBAR + 16 + 1024;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Wait for the phase of parity `parity` to complete. A transaction that
// never arrives traps (a launch error) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (n == (1u << 26)) __trap();
  }
}

// rows [t0, t0 + 64) of head h of batch row b: one 8 KB tile
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int h, int t0, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(h), "r"(t0), "r"(b), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor, 128-B swizzle: start address, leading and
// stride byte offsets, all in 16-B units.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// K-major operand (Q, K: Dh contiguous), k-step kk: 16 Dh = 32 B into each
// swizzled row; 8-row groups 1 KB apart.
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int kk) {
  return desc(tile + 32u * kk, 16, 1024);
}

// MN-major operand (V: keys x Dh, Dh contiguous, read transposed), k-step kk:
// 16 keys = 2 KB; the 8-key groups inside a step 1 KB apart (stride byte
// offset); the leading offset would step to a second 64-wide column block,
// which an N of 64 never reaches.
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int kk) {
  return desc(tile + 2048u * kk, TILE_BYTES, 1024);
}

// 2^x on the SFU, subnormal results flushed to 0: a p below 2^-126 is
// nothing beside the row's largest p = 1 in l, nor in a 16-bit P.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void fence_operand(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void fence_operand(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}
// every register of a wgmma operand: the compiler may not move reads or
// writes of it across the asynchronous product
template <typename R, int N>
__device__ __forceinline__ void fence_all(R (&r)[N]) {
#pragma unroll
  for (int e = 0; e < N; ++e) fence_operand(r[e]);
}

// The hash's terms of index i on an axis of logical tiles of `tile` rows:
// (tile index + 1) * ct and (position in the tile) * cp.
__device__ __forceinline__ void hash_terms(int i, int tile, uint32_t ct, uint32_t cp,
                                           uint32_t& term, uint32_t& pos) {
  const int n = i / tile;
  term = (uint32_t)(n + 1) * ct;
  pos = (uint32_t)(i - n * tile) * cp;
}

// The hash's seed and head terms: (seed * C0) ^ ((b*H + h + 1) * C1), b the
// row in the global batch.
__device__ __forceinline__ uint32_t head_term(const Drop& dr, int bh) {
  return (dr.seed * H_SEED) ^ (((uint32_t)(bh + 1) + dr.bh0) * H_BH);
}

// Dropout keep bits of a thread's 32 accumulator values of a 64 x 64 tile,
// bit e for value e (layout below). The hash is x = h + row * H_ROW +
// col * H_COL (mod 2^32) with h the XOR of the seed, head and logical-tile
// terms; the tile's rows and columns each lie on the query or the key axis.
// r and c are the position terms of this thread's first row and column,
// rstep and cstep the multipliers of their axes (H_ROW for queries, H_COL
// for keys). A 64-aligned tile of 64 lies in one logical tile (ceil8(T)
// >= T rows, or 128), so h is one value for the whole tile.
__device__ __forceinline__ uint32_t keep_bits(const Drop& dr, uint32_t h, uint32_t r,
                                              uint32_t rstep, uint32_t c, uint32_t cstep) {
  uint32_t bits = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint32_t x = h + r + 8u * i * rstep + c + 8u * j * cstep;
      if (kept(dr, x)) bits |= 1u << (4 * j + 2 * i);
      if (kept(dr, x + cstep)) bits |= 1u << (4 * j + 2 * i + 1);
    }
  return bits;
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

#define TC_D32                                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define TC_D32_OUT(d)                                                                       \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),      \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),           \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),        \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),        \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),        \
      "+f"(d[31])
// D (64 x 64, fp32) (+)= A (64 x 16, smem) . B (16 x 64, smem, K-major)
#define TC_WGMMA_SS(TY)                                                                     \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                                \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " TC_D32         \
               ", %32, %33, p, 1, 1, 0, 0;\n}\n"                                           \
               : TC_D32_OUT(d)                                                             \
               : "l"(da), "l"(db), "r"(accumulate))
// D (64 x 64, fp32) += A (64 x 16, registers) . B (16 x 64, smem, MN-major)
#define TC_WGMMA_RS(TY)                                                                     \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                                \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " TC_D32         \
               ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                             \
               : TC_D32_OUT(d)                                                             \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

template <typename T> struct Mma;
template <> struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da, uint64_t db,
                                            int accumulate) {
    TC_WGMMA_SS("bf16");
  }
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t* a, uint64_t db) {
    TC_WGMMA_RS("bf16");
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
};
template <> struct Mma<__half> {
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da, uint64_t db,
                                            int accumulate) {
    TC_WGMMA_SS("f16");
  }
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t* a, uint64_t db) {
    TC_WGMMA_RS("f16");
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
};

// D = A B^T over a depth of 64: A and B 64 x 64 K-major tiles in shared
// memory (issued, not waited for)
template <typename T>
__device__ __forceinline__ void mma_ss(float (&d)[32], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) Mma<T>::ss(d, desc_kmajor(a, kk), desc_kmajor(b, kk), kk > 0);
}

// D += A B over a depth of 64: A packed in registers (k-step kk in
// a[4kk .. 4kk + 3]), B a 64 x 64 tile read MN-major (issued, not waited for)
template <typename T>
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[16], uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) Mma<T>::rs(d, a + 4 * kk, desc_mnmajor(b, kk));
}

// the 32 values of an accumulator rounded in pairs to the A operand
template <typename T>
__device__ __forceinline__ void pack_all(uint32_t (&a)[16], const float (&d)[32]) {
#pragma unroll
  for (int e = 0; e < 16; ++e) a[e] = Mma<T>::pack(d[2 * e], d[2 * e + 1]);
}

}  // namespace tc

// Accumulator layout (wgmma m64nNk16, fp32): thread (warp w, lane l) holds
// rows r = 16w + l/4 and r + 8; of each 8-column block j, columns
// 8j + 2(l%4) and + 1, as d[4j + 2*half + c]. So a row's values sit in one
// quad of lanes (two shuffles reduce a row), and the values of S for keys
// 16kk .. 16kk + 15 are, packed in pairs, exactly the A fragment of the
// register-A wgmma for k-step kk.
template <typename T, bool WITH_L>
__global__ void __launch_bounds__(tc::THREADS, 4)
fwd_tc_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
              const __grid_constant__ CUtensorMap tm_v, const float* __restrict__ bias,
              T* __restrict__ out, float* __restrict__ lse, int H, int Tq, int Tk,
              float scale, Drop dr) {
  extern __shared__ uint8_t tc_smem[];
  const uint32_t base = ((uint32_t)__cvta_generic_to_shared(tc_smem) + 1023u) & ~1023u;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = blockIdx.y * tc::ROWS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int quad = lane & 3;
  const int n_tiles = (Tk + tc::KEYS - 1) / tc::KEYS;
  const uint32_t bar = base + tc::SBAR;  // stage st: bar + 8 st
  const auto k_at = [&](int st) { return base + tc::SK + st * tc::TILE_BYTES; };
  const auto v_at = [&](int st) { return base + tc::SV + st * tc::TILE_BYTES; };
  if (threadIdx.x == 0) {
    tc::mbar_init(bar);
    tc::mbar_init(bar + 8);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {  // Q rides on stage 0's barrier: one arrival, three copies
    tc::mbar_expect(bar, 3 * tc::TILE_BYTES);
    tc::tma_tile(base + tc::SQ, &tm_q, bar, h, q0, b);
    tc::tma_tile(k_at(0), &tm_k, bar, h, 0, b);
    tc::tma_tile(v_at(0), &tm_v, bar, h, 0, b);
  }

  // this thread's two rows, and the dropout hash's terms of its rows
  const int row[2] = {q0 + 16 * warp + (lane >> 2), q0 + 16 * warp + (lane >> 2) + 8};
  uint32_t hq = 0, rq = 0;
  if (WITH_L && dr.on) tc::hash_terms(row[0], dr.q_tile, H_QT, H_ROW, hq, rq);
  hq ^= tc::head_term(dr, bh);
  const float* biasb = bias == nullptr ? nullptr : bias + (size_t)b * Tk;
  float s[32], o[32], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int e = 0; e < 32; ++e) s[e] = o[e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    if (threadIdx.x == 0 && t + 1 < n_tiles) {  // stage st^1 was freed at the end of t-1
      const uint32_t nb = bar + 8 * (st ^ 1);
      tc::mbar_expect(nb, 2 * tc::TILE_BYTES);
      tc::tma_tile(k_at(st ^ 1), &tm_k, nb, h, (t + 1) * tc::KEYS, b);
      tc::tma_tile(v_at(st ^ 1), &tm_v, nb, h, (t + 1) * tc::KEYS, b);
    }
    // the additive bias of this thread's 16 keys while the tiles land; keys
    // past Tk get -inf
    const int k0 = t * tc::KEYS;
    float add[16];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int key = k0 + 8 * j + 2 * quad + c;
        add[2 * j + c] = key >= Tk ? -INFINITY : (biasb != nullptr ? __ldg(biasb + key) : 0.f);
      }

    // S = Q K^T
    tc::mbar_wait(bar + 8 * st, (t >> 1) & 1);
    __syncwarp();
    tc::fence_all(s);
    tc::wg_fence();
    tc::mma_ss<T>(s, base + tc::SQ, k_at(st));
    tc::wg_commit();
    tc::wg_wait0();
    tc::fence_all(s);

    // online softmax over the tile, as the reference: max floored at -1e9,
    // l summed from the fp32 p before dropout
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int j = e >> 2, i = (e >> 1) & 1, c = e & 1;
      s[e] = s[e] * scale + add[2 * j + c];
      mx[i] = fmaxf(mx[i], s[e]);
    }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      corr[i] = tc::ex2((m[i] - mx[i]) * tc::LOG2E);
      m[i] = mx[i];
      l[i] *= corr[i];
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int i = (e >> 1) & 1;
      s[e] = tc::ex2((s[e] - m[i]) * tc::LOG2E);
      l[i] += s[e];
    }
    // once the running max settles, whole warps skip rescaling O
    if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
      for (int e = 0; e < 32; ++e) o[e] *= corr[(e >> 1) & 1];
    }
    // dropout: a dropped p becomes 0; the kept ones' 1/(1-p) is a constant
    // factor of O, applied once in the epilogue
    if (WITH_L && dr.on) {
      uint32_t hk, ck;
      tc::hash_terms(k0, dr.k_tile, H_KT, H_COL, hk, ck);
      const uint32_t bits = tc::keep_bits(dr, hq ^ hk, rq, H_ROW, ck + 2u * quad * H_COL, H_COL);
#pragma unroll
      for (int e = 0; e < 32; ++e)
        if (!((bits >> e) & 1u)) s[e] = 0.f;
    }
    uint32_t p[16];
    tc::pack_all<T>(p, s);

    // O += P V
    tc::fence_all(o);
    tc::fence_all(p);
    tc::wg_fence();
    tc::mma_rs<T>(o, p, v_at(st));
    tc::wg_commit();
    tc::wg_wait0();
    tc::fence_all(o);
    __syncthreads();  // every warp is done with stage st: it may be refilled
  }

  // epilogue: O / max(l, 1e-30) in place in (B, Tq, H, Dh); L as (B*H, Tq)
  const size_t rs = (size_t)H * tc::DH;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    if (row[i] >= Tq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    const float keep = WITH_L && dr.on ? dr.inv_keep : 1.f;
    T* orow = out + ((size_t)b * Tq + row[i]) * rs + (size_t)h * tc::DH + 2 * quad;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j) = tc::Mma<T>::pack(
          keep * o[4 * j + 2 * i] / den, keep * o[4 * j + 2 * i + 1] / den);
    if (WITH_L && quad == 0)
      lse[(size_t)bh * Tq + row[i]] = l[i] > 0.f ? m[i] + logf(den) : NEG_INF;
  }
}

// ---- backward on the tensor cores: bf16 / fp16, Dh 64 ---------------------
// Both kernels: one warpgroup per (b*H + h, 64 output rows). The two tiles
// the block owns come by TMA at the start with the first stage of the
// ring; thread 0 keeps the next streamed stage in flight while the
// warpgroup computes the current one. L and delta are read as the CUDA-core
// kernels read them; the order scale * s + bias - L, then the exponential,
// is theirs too (a row whose keys are all padded has bias -1e9, where fp32
// steps are 64 apart, so another order would change P).

// dQ = scale * sum_j dS K, dS = P o (dP o mask - delta), P = exp(scale S +
// bias - L), S = Q K^T, dP = dO V^T. Q and dO resident, K and V streamed.
template <typename T>
__global__ void __launch_bounds__(tc::THREADS, 2)
dq_tc_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
             const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
             const float* __restrict__ bias, const float* __restrict__ lse,
             const float* __restrict__ delta, T* __restrict__ dq, int H, int Tq, int Tk,
             float scale, Drop dr) {
  extern __shared__ uint8_t tc_smem[];
  const uint32_t base = ((uint32_t)__cvta_generic_to_shared(tc_smem) + 1023u) & ~1023u;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = blockIdx.y * tc::ROWS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int quad = lane & 3;
  const int n_tiles = (Tk + tc::KEYS - 1) / tc::KEYS;
  const uint32_t bar = base + tc::BBAR;  // stage st: bar + 8 st
  const auto k_at = [&](int st) { return base + tc::BR0 + st * tc::TILE_BYTES; };
  const auto v_at = [&](int st) { return base + tc::BR1 + st * tc::TILE_BYTES; };
  if (threadIdx.x == 0) {
    tc::mbar_init(bar);
    tc::mbar_init(bar + 8);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {  // Q and dO ride on stage 0's barrier: one arrival, four copies
    tc::mbar_expect(bar, 4 * tc::TILE_BYTES);
    tc::tma_tile(base + tc::BA, &tm_q, bar, h, q0, b);
    tc::tma_tile(base + tc::BB, &tm_do, bar, h, q0, b);
    tc::tma_tile(k_at(0), &tm_k, bar, h, 0, b);
    tc::tma_tile(v_at(0), &tm_v, bar, h, 0, b);
  }

  // this thread's two query rows: L, delta and the hash's terms of its rows
  const int row[2] = {q0 + 16 * warp + (lane >> 2), q0 + 16 * warp + (lane >> 2) + 8};
  float L[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    L[i] = row[i] < Tq ? lse[(size_t)bh * Tq + row[i]] : 0.f;
    dl[i] = row[i] < Tq ? delta[(size_t)bh * Tq + row[i]] : 0.f;
  }
  uint32_t hq = 0, rq = 0;
  if (dr.on) tc::hash_terms(row[0], dr.q_tile, H_QT, H_ROW, hq, rq);
  hq ^= tc::head_term(dr, bh);
  const float keep = dr.on ? dr.inv_keep : 1.f;
  const float* biasb = bias == nullptr ? nullptr : bias + (size_t)b * Tk;
  float acc[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    if (threadIdx.x == 0 && t + 1 < n_tiles) {  // stage st^1 was freed at the end of t-1
      const uint32_t nb = bar + 8 * (st ^ 1);
      tc::mbar_expect(nb, 2 * tc::TILE_BYTES);
      tc::tma_tile(k_at(st ^ 1), &tm_k, nb, h, (t + 1) * tc::KEYS, b);
      tc::tma_tile(v_at(st ^ 1), &tm_v, nb, h, (t + 1) * tc::KEYS, b);
    }
    // the additive term of this thread's 16 keys while the tiles land; keys
    // past Tk get -inf
    const int k0 = t * tc::KEYS;
    float add[16];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int key = k0 + 8 * j + 2 * quad + c;
        add[2 * j + c] = key >= Tk ? -INFINITY : (biasb != nullptr ? __ldg(biasb + key) : 0.f);
      }

    // S = Q K^T and dP = dO V^T, one group
    float s[32], dp[32];
    tc::mbar_wait(bar + 8 * st, (t >> 1) & 1);
    __syncwarp();
    tc::fence_all(s);
    tc::fence_all(dp);
    tc::wg_fence();
    tc::mma_ss<T>(s, base + tc::BA, k_at(st));
    tc::mma_ss<T>(dp, base + tc::BB, v_at(st));
    tc::wg_commit();
    tc::wg_wait0();
    tc::fence_all(s);
    tc::fence_all(dp);

    uint32_t bits = ~0u;
    if (dr.on) {
      uint32_t hk, ck;
      tc::hash_terms(k0, dr.k_tile, H_KT, H_COL, hk, ck);
      bits = tc::keep_bits(dr, hq ^ hk, rq, H_ROW, ck + 2u * quad * H_COL, H_COL);
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int j = e >> 2, i = (e >> 1) & 1, c = e & 1;
      const float p = tc::ex2((scale * s[e] + add[2 * j + c] - L[i]) * tc::LOG2E);
      const float dpd = (bits >> e) & 1u ? dp[e] * keep : 0.f;
      s[e] = p * (dpd - dl[i]);  // dS
    }
    uint32_t a[16];
    tc::pack_all<T>(a, s);

    // dQ += dS K, K read MN-major
    tc::fence_all(acc);
    tc::fence_all(a);
    tc::wg_fence();
    tc::mma_rs<T>(acc, a, k_at(st));
    tc::wg_commit();
    tc::wg_wait0();
    tc::fence_all(acc);
    __syncthreads();  // every warp is done with stage st: it may be refilled
  }

  // epilogue: dQ * scale in place in (B, Tq, H, Dh)
  const size_t rs = (size_t)H * tc::DH;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= Tq) continue;
    T* orow = dq + ((size_t)b * Tq + row[i]) * rs + (size_t)h * tc::DH + 2 * quad;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j) =
          tc::Mma<T>::pack(scale * acc[4 * j + 2 * i], scale * acc[4 * j + 2 * i + 1]);
  }
}

// dV = sum_i (P o mask)^T dO, dK = scale * sum_i dS^T Q, in the key-major
// orientation: the accumulators' rows are this block's 64 keys, their
// columns a streamed tile's 64 queries. So the bias is per row (key) and
// L, delta per column (query); the hash's row argument is the query, i.e.
// the accumulator's column. K and V resident, Q and dO streamed; L and
// delta of the next tile go through a two-stage buffer of their own.
template <typename T>
__global__ void __launch_bounds__(tc::THREADS, 2)
dkv_tc_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
              const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
              const float* __restrict__ bias, const float* __restrict__ lse,
              const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int H,
              int Tq, int Tk, float scale, Drop dr) {
  extern __shared__ uint8_t tc_smem[];
  __shared__ float2 ld_s[2][tc::ROWS];  // (L, delta) of a query tile, two stages
  const uint32_t base = ((uint32_t)__cvta_generic_to_shared(tc_smem) + 1023u) & ~1023u;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * tc::KEYS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int quad = lane & 3;
  const int n_tiles = (Tq + tc::ROWS - 1) / tc::ROWS;
  const uint32_t bar = base + tc::BBAR;  // stage st: bar + 8 st
  const auto q_at = [&](int st) { return base + tc::BR0 + st * tc::TILE_BYTES; };
  const auto do_at = [&](int st) { return base + tc::BR1 + st * tc::TILE_BYTES; };
  // (L, delta) of query i; a query past Tq gets L = +inf, so its P is exactly 0
  const auto l_delta = [&](int i) {
    return i < Tq ? make_float2(lse[(size_t)bh * Tq + i], delta[(size_t)bh * Tq + i])
                  : make_float2(INFINITY, 0.f);
  };
  if (threadIdx.x == 0) {
    tc::mbar_init(bar);
    tc::mbar_init(bar + 8);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (threadIdx.x < tc::ROWS) ld_s[0][threadIdx.x] = l_delta(threadIdx.x);
  __syncthreads();
  if (threadIdx.x == 0) {  // K and V ride on stage 0's barrier: one arrival, four copies
    tc::mbar_expect(bar, 4 * tc::TILE_BYTES);
    tc::tma_tile(base + tc::BA, &tm_k, bar, h, k0, b);
    tc::tma_tile(base + tc::BB, &tm_v, bar, h, k0, b);
    tc::tma_tile(q_at(0), &tm_q, bar, h, 0, b);
    tc::tma_tile(do_at(0), &tm_do, bar, h, 0, b);
  }

  // this thread's two keys: their additive term (-inf past Tk) and the
  // hash's terms of its rows (the key axis)
  const int key[2] = {k0 + 16 * warp + (lane >> 2), k0 + 16 * warp + (lane >> 2) + 8};
  float add[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    add[i] = key[i] >= Tk ? -INFINITY : (bias != nullptr ? bias[(size_t)b * Tk + key[i]] : 0.f);
  uint32_t hk = 0, rk = 0;
  if (dr.on) tc::hash_terms(key[0], dr.k_tile, H_KT, H_COL, hk, rk);
  hk ^= tc::head_term(dr, bh);
  const float keep = dr.on ? dr.inv_keep : 1.f;
  float gk[32], gv[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) gk[e] = gv[e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    const int i0 = t * tc::ROWS;
    if (threadIdx.x == 0 && t + 1 < n_tiles) {  // stage st^1 was freed at the end of t-1
      const uint32_t nb = bar + 8 * (st ^ 1);
      tc::mbar_expect(nb, 2 * tc::TILE_BYTES);
      tc::tma_tile(q_at(st ^ 1), &tm_q, nb, h, i0 + tc::ROWS, b);
      tc::tma_tile(do_at(st ^ 1), &tm_do, nb, h, i0 + tc::ROWS, b);
    }
    // L and delta of the next tile, loaded now, stored at the end of this one
    const bool loads_next = threadIdx.x < tc::ROWS && t + 1 < n_tiles;
    const float2 next = loads_next ? l_delta(i0 + tc::ROWS + threadIdx.x) : make_float2(0.f, 0.f);

    // S^T = K Q^T and dP^T = V dO^T, one group
    float s[32], dp[32];
    tc::mbar_wait(bar + 8 * st, (t >> 1) & 1);
    __syncwarp();
    tc::fence_all(s);
    tc::fence_all(dp);
    tc::wg_fence();
    tc::mma_ss<T>(s, base + tc::BA, q_at(st));
    tc::mma_ss<T>(dp, base + tc::BB, do_at(st));
    tc::wg_commit();
    tc::wg_wait0();
    tc::fence_all(s);
    tc::fence_all(dp);

    uint32_t bits = ~0u;
    if (dr.on) {  // rows are keys (H_COL), columns queries (H_ROW)
      uint32_t hq, cq;
      tc::hash_terms(i0, dr.q_tile, H_QT, H_ROW, hq, cq);
      bits = tc::keep_bits(dr, hk ^ hq, rk, H_COL, cq + 2u * quad * H_ROW, H_ROW);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float2 ld = ld_s[st][8 * j + 2 * quad + c];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int e = 4 * j + 2 * i + c;
          const float p = tc::ex2((scale * s[e] + add[i] - ld.x) * tc::LOG2E);
          const float m = (bits >> e) & 1u ? keep : 0.f;
          s[e] = p * m;                    // P o mask
          dp[e] = p * (dp[e] * m - ld.y);  // dS
        }
      }
    uint32_t a_v[16], a_k[16];
    tc::pack_all<T>(a_v, s);
    tc::pack_all<T>(a_k, dp);

    // dV += (P o mask)^T dO and dK += dS^T Q, dO and Q read MN-major
    tc::fence_all(gv);
    tc::fence_all(gk);
    tc::fence_all(a_v);
    tc::fence_all(a_k);
    tc::wg_fence();
    tc::mma_rs<T>(gv, a_v, do_at(st));
    tc::mma_rs<T>(gk, a_k, q_at(st));
    tc::wg_commit();
    tc::wg_wait0();
    tc::fence_all(gv);
    tc::fence_all(gk);
    if (loads_next) ld_s[st ^ 1][threadIdx.x] = next;
    __syncthreads();  // stage st is consumed and stage st^1's L and delta are written
  }

  // epilogue: dK * scale and dV in place in (B, Tk, H, Dh)
  const size_t rs = (size_t)H * tc::DH;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (key[i] >= Tk) continue;
    const size_t off = ((size_t)b * Tk + key[i]) * rs + (size_t)h * tc::DH + 2 * quad;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<uint32_t*>(dk + off + 8 * j) =
          tc::Mma<T>::pack(scale * gk[4 * j + 2 * i], scale * gk[4 * j + 2 * i + 1]);
      *reinterpret_cast<uint32_t*>(dv + off + 8 * j) =
          tc::Mma<T>::pack(gv[4 * j + 2 * i], gv[4 * j + 2 * i + 1]);
    }
  }
}

// ---- backward dQ: one block per (b*H + h, 32 query rows); streams keys ----
// dQ = scale * sum_j P o (dO V^T o mask - delta) K, delta = rowsum(dO o O)
template <typename T>
__global__ void __launch_bounds__(THREADS)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const float* __restrict__ bias, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dq, int H, int Tq, int Tk, int Dh, float scale, Drop dr) {
  extern __shared__ float smem[];
  const int ld = Dh + 1;
  float* ks = smem;                     // [TILE][ld]
  float* vs = ks + TILE * ld;           // [TILE][ld]
  float* qs = vs + TILE * ld;           // [BLOCK_ROWS][Dh]
  float* dos = qs + BLOCK_ROWS * Dh;    // [BLOCK_ROWS][Dh]
  float* ps = dos + BLOCK_ROWS * Dh;    // [WARPS][ROWS][TILE] dS
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = blockIdx.y * BLOCK_ROWS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t rs = (size_t)H * Dh;
  const size_t qoff = (size_t)b * Tq * rs + (size_t)h * Dh;
  const T* kb = k + (size_t)b * Tk * rs + (size_t)h * Dh;
  const T* vb = v + (size_t)b * Tk * rs + (size_t)h * Dh;
  const float* biasb = bias == nullptr ? nullptr : bias + (size_t)b * Tk;
  load_rows(qs, Dh, q + qoff, rs, q0, BLOCK_ROWS, Tq, Dh, 1.f);
  load_rows(dos, Dh, dout + qoff, rs, q0, BLOCK_ROWS, Tq, Dh, 1.f);

  float L[ROWS], dl[ROWS], acc[ROWS][DPL];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int i = q0 + warp * ROWS + r;
    L[r] = i < Tq ? lse[(size_t)bh * Tq + i] : 0.f;
    dl[r] = i < Tq ? delta[(size_t)bh * Tq + i] : 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[r][c] = 0.f;
  }
  const float* qw = qs + warp * ROWS * Dh;
  const float* dow = dos + warp * ROWS * Dh;
  float* pw = ps + warp * ROWS * TILE;
  const int n_tiles = (Tk + TILE - 1) / TILE;
  for (int t = 0; t < n_tiles; ++t) {
    __syncthreads();
    load_rows(ks, ld, kb, rs, t * TILE, TILE, Tk, Dh, 1.f);
    load_rows(vs, ld, vb, rs, t * TILE, TILE, Tk, Dh, 1.f);
    __syncthreads();
    const int key = t * TILE + lane;
    const bool kin = key < Tk;
    const float add = (kin && biasb != nullptr) ? biasb[key] : 0.f;
    float s[ROWS], dp[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r] = dp[r] = 0.f;
    for (int d = 0; d < Dh; ++d) {
      const float kd = ks[lane * ld + d], vd = vs[lane * ld + d];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        s[r] += qw[r * Dh + d] * kd;
        dp[r] += dow[r * Dh + d] * vd;
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      float ds = 0.f;
      if (kin) {
        const float p = expf(scale * s[r] + add - L[r]);
        float dpd = dp[r];
        if (dr.on) dpd *= keep_scale(dr, (uint32_t)bh, q0 + warp * ROWS + r, key);
        ds = p * (dpd - dl[r]);
      }
      pw[r * TILE + lane] = ds;
    }
    __syncwarp();
    const int nk = min(TILE, Tk - t * TILE);
    for (int j = 0; j < nk; ++j) {
#pragma unroll
      for (int c = 0; c < DPL; ++c) {
        const int d = lane + 32 * c;
        if (d < Dh) {
          const float kd = ks[j * ld + d];
#pragma unroll
          for (int r = 0; r < ROWS; ++r) acc[r][c] += pw[r * TILE + j] * kd;
        }
      }
    }
    __syncwarp();
  }
  T* db = dq + qoff;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int i = q0 + warp * ROWS + r;
    if (i >= Tq) continue;
#pragma unroll
    for (int c = 0; c < DPL; ++c) {
      const int d = lane + 32 * c;
      if (d < Dh) db[(size_t)i * rs + d] = from_f<T>(acc[r][c] * scale);
    }
  }
}

// ---- backward dK/dV: one block per (b*H + h, 32 keys); streams queries ----
// dV = sum_i (P o mask)^T dO;  dK = scale * sum_i dS^T Q
template <typename T>
__global__ void __launch_bounds__(THREADS)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const float* __restrict__ bias, const T* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           T* __restrict__ dk, T* __restrict__ dv, int H, int Tq, int Tk, int Dh,
           float scale, Drop dr) {
  extern __shared__ float smem[];
  const int ld = Dh + 1;
  float* qs = smem;                     // [TILE][ld]
  float* dos = qs + TILE * ld;          // [TILE][ld]
  float* ls = dos + TILE * ld;          // [TILE]
  float* dls = ls + TILE;               // [TILE]
  float* kws = dls + TILE;              // [BLOCK_ROWS][Dh]
  float* vws = kws + BLOCK_ROWS * Dh;   // [BLOCK_ROWS][Dh]
  float* pm = vws + BLOCK_ROWS * Dh;    // [WARPS][ROWS][TILE] P o mask
  float* dss = pm + BLOCK_ROWS * TILE;  // [WARPS][ROWS][TILE] dS
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * BLOCK_ROWS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t rs = (size_t)H * Dh;
  const size_t qoff = (size_t)b * Tq * rs + (size_t)h * Dh;
  const size_t koff = (size_t)b * Tk * rs + (size_t)h * Dh;
  load_rows(kws, Dh, k + koff, rs, k0, BLOCK_ROWS, Tk, Dh, 1.f);
  load_rows(vws, Dh, v + koff, rs, k0, BLOCK_ROWS, Tk, Dh, 1.f);

  float add[ROWS], gk[ROWS][DPL], gv[ROWS][DPL];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int key = k0 + warp * ROWS + r;
    add[r] = (bias != nullptr && key < Tk) ? bias[(size_t)b * Tk + key] : 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) gk[r][c] = gv[r][c] = 0.f;
  }
  const float* kw = kws + warp * ROWS * Dh;
  const float* vw = vws + warp * ROWS * Dh;
  float* pmw = pm + warp * ROWS * TILE;
  float* dsw = dss + warp * ROWS * TILE;
  const int n_tiles = (Tq + TILE - 1) / TILE;
  for (int t = 0; t < n_tiles; ++t) {
    __syncthreads();
    load_rows(qs, ld, q + qoff, rs, t * TILE, TILE, Tq, Dh, 1.f);
    load_rows(dos, ld, dout + qoff, rs, t * TILE, TILE, Tq, Dh, 1.f);
    if (threadIdx.x < TILE) {
      const int i = t * TILE + threadIdx.x;
      // a missing query gets L = +inf, so its recomputed P is exactly 0
      ls[threadIdx.x] = i < Tq ? lse[(size_t)bh * Tq + i] : INFINITY;
      dls[threadIdx.x] = i < Tq ? delta[(size_t)bh * Tq + i] : 0.f;
    }
    __syncthreads();
    const int i = t * TILE + lane;  // this lane's query
    float s[ROWS], dp[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r] = dp[r] = 0.f;
    for (int d = 0; d < Dh; ++d) {
      const float qd = qs[lane * ld + d], dod = dos[lane * ld + d];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        s[r] += qd * kw[r * Dh + d];
        dp[r] += dod * vw[r * Dh + d];
      }
    }
    const float Li = ls[lane], di = dls[lane];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float p = expf(scale * s[r] + add[r] - Li);
      float mask = 1.f;
      if (dr.on && i < Tq) mask = keep_scale(dr, (uint32_t)bh, i, k0 + warp * ROWS + r);
      pmw[r * TILE + lane] = p * mask;
      dsw[r * TILE + lane] = p * (dp[r] * mask - di);
    }
    __syncwarp();
    const int nq = min(TILE, Tq - t * TILE);
    for (int j = 0; j < nq; ++j) {
#pragma unroll
      for (int c = 0; c < DPL; ++c) {
        const int d = lane + 32 * c;
        if (d < Dh) {
          const float qd = qs[j * ld + d], dod = dos[j * ld + d];
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            gv[r][c] += pmw[r * TILE + j] * dod;
            gk[r][c] += dsw[r * TILE + j] * qd;
          }
        }
      }
    }
    __syncwarp();
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int key = k0 + warp * ROWS + r;
    if (key >= Tk) continue;
#pragma unroll
    for (int c = 0; c < DPL; ++c) {
      const int d = lane + 32 * c;
      if (d < Dh) {
        dk[koff + (size_t)key * rs + d] = from_f<T>(gk[r][c] * scale);
        dv[koff + (size_t)key * rs + d] = from_f<T>(gv[r][c]);
      }
    }
  }
}

enum DType { F32 = 0, BF16 = 1, F16 = 2 };

// Raise a kernel's dynamic shared-memory limit on the launching (current)
// device, to the largest size asked for so far there (the default cap is
// 48 KB). cudaFuncSetAttribute acts on the current device only and one
// process may launch on several cards, so each kernel keeps the size
// raised per device ordinal, checked and raised under one lock.
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

inline dim3 grid_of(int B, int H, int T) {
  return dim3((unsigned)(B * H), (unsigned)((T + BLOCK_ROWS - 1) / BLOCK_ROWS));
}

template <typename T>
cudaError_t launch_fwd_simt(const void* q, const void* k, const void* v, const void* bias,
                            void* out, void* lse, int B, int H, int Tq, int Tk, int Dh,
                            float scale, Drop dr, cudaStream_t st) {
  const size_t smem =
      sizeof(float) * (2 * TILE * (Dh + 1) + BLOCK_ROWS * Dh + BLOCK_ROWS * TILE);
  cudaError_t e;
  if (lse != nullptr) {
    static SmemRaised raised;
    e = allow_smem(fwd_kernel<T, true>, smem, raised);
    if (e != cudaSuccess) return e;
    fwd_kernel<T, true><<<grid_of(B, H, Tq), THREADS, smem, st>>>(
        (const T*)q, (const T*)k, (const T*)v, (const float*)bias, (T*)out, (float*)lse, H,
        Tq, Tk, Dh, scale, dr);
  } else {
    static SmemRaised raised;
    e = allow_smem(fwd_kernel<T, false>, smem, raised);
    if (e != cudaSuccess) return e;
    fwd_kernel<T, false><<<grid_of(B, H, Tq), THREADS, smem, st>>>(
        (const T*)q, (const T*)k, (const T*)v, (const float*)bias, (T*)out, nullptr, H, Tq,
        Tk, Dh, scale, dr);
  }
  return cudaGetLastError();
}

// Codes beside cudaError_t's for the tensor-core kernels' set-up.
constexpr int ERR_NO_ENCODE = 10001;  // libcuda has no cuTensorMapEncodeTiled
constexpr int ERR_ENCODE = 10002;     // it refused a map (e.g. a pointer not 16-B aligned)
constexpr int ERR_TC_ARGS = 10003;    // a tensor-core kernel asked for other than bf16/fp16 at Dh 64

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// A (B, T, H, 64) 16-bit tensor as the 4-D map (Dh, H, T, B), boxes of
// 64 rows of one head; rows past T read as zeros.
bool tile_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, CUtensorMapDataType type,
              int B, int H, int T) {
  const cuuint64_t row = (cuuint64_t)tc::DH * 2;
  const cuuint64_t dims[4] = {(cuuint64_t)tc::DH, (cuuint64_t)H, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[3] = {row, row * H, row * H * T};  // bytes, dims 1..3
  const cuuint32_t box[4] = {(cuuint32_t)tc::DH, 1, (cuuint32_t)tc::ROWS, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, type, 4, const_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The maps of q, k, v and (dout != nullptr) dout: m[0 .. 3]. They hold the
// tensors' pointers, so they are built for every call. 0 or an ERR_* code.
template <typename T>
int tc_maps(CUtensorMap* m, const void* q, const void* k, const void* v, const void* dout,
            int B, int H, int Tq, int Tk) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return ERR_NO_ENCODE;
  const CUtensorMapDataType type = std::is_same<T, __half>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (!tile_map(enc, &m[0], q, type, B, H, Tq) || !tile_map(enc, &m[1], k, type, B, H, Tk) ||
      !tile_map(enc, &m[2], v, type, B, H, Tk) ||
      (dout != nullptr && !tile_map(enc, &m[3], dout, type, B, H, Tq)))
    return ERR_ENCODE;
  return 0;
}

inline dim3 tc_grid(int B, int H, int T) {
  return dim3((unsigned)(B * H), (unsigned)((T + tc::ROWS - 1) / tc::ROWS));
}

template <typename T>
int launch_fwd_tc(const void* q, const void* k, const void* v, const void* bias, void* out,
                  void* lse, int B, int H, int Tq, int Tk, float scale, Drop dr,
                  cudaStream_t st) {
  CUtensorMap m[3];
  const int e = tc_maps<T>(m, q, k, v, nullptr, B, H, Tq, Tk);
  if (e != 0) return e;
  if (lse != nullptr)
    fwd_tc_kernel<T, true><<<tc_grid(B, H, Tq), tc::THREADS, tc::SMEM, st>>>(
        m[0], m[1], m[2], (const float*)bias, (T*)out, (float*)lse, H, Tq, Tk, scale, dr);
  else
    fwd_tc_kernel<T, false><<<tc_grid(B, H, Tq), tc::THREADS, tc::SMEM, st>>>(
        m[0], m[1], m[2], (const float*)bias, (T*)out, nullptr, H, Tq, Tk, scale, dr);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dq_tc(const void* q, const void* k, const void* v, const void* bias,
                 const void* dout, const void* lse, const void* delta, void* dq, int B, int H,
                 int Tq, int Tk, float scale, Drop dr, cudaStream_t st) {
  CUtensorMap m[4];
  int e = tc_maps<T>(m, q, k, v, dout, B, H, Tq, Tk);
  if (e != 0) return e;
  static SmemRaised raised;
  e = (int)allow_smem(dq_tc_kernel<T>, tc::BWD_SMEM, raised);
  if (e != 0) return e;
  dq_tc_kernel<T><<<tc_grid(B, H, Tq), tc::THREADS, tc::BWD_SMEM, st>>>(
      m[0], m[1], m[2], m[3], (const float*)bias, (const float*)lse, (const float*)delta,
      (T*)dq, H, Tq, Tk, scale, dr);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dkv_tc(const void* q, const void* k, const void* v, const void* bias,
                  const void* dout, const void* lse, const void* delta, void* dk, void* dv,
                  int B, int H, int Tq, int Tk, float scale, Drop dr, cudaStream_t st) {
  CUtensorMap m[4];
  int e = tc_maps<T>(m, q, k, v, dout, B, H, Tq, Tk);
  if (e != 0) return e;
  static SmemRaised raised;
  e = (int)allow_smem(dkv_tc_kernel<T>, tc::BWD_SMEM, raised);
  if (e != 0) return e;
  dkv_tc_kernel<T><<<tc_grid(B, H, Tk), tc::THREADS, tc::BWD_SMEM, st>>>(
      m[0], m[1], m[2], m[3], (const float*)bias, (const float*)lse, (const float*)delta,
      (T*)dk, (T*)dv, H, Tq, Tk, scale, dr);
  return (int)cudaGetLastError();
}

template <typename T>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* bias,
                      const void* dout, const void* lse, const void* delta, void* dq, int B,
                      int H, int Tq, int Tk, int Dh, float scale, Drop dr, cudaStream_t st) {
  const size_t smem =
      sizeof(float) * (2 * TILE * (Dh + 1) + 2 * BLOCK_ROWS * Dh + BLOCK_ROWS * TILE);
  static SmemRaised raised;
  const cudaError_t e = allow_smem(dq_kernel<T>, smem, raised);
  if (e != cudaSuccess) return e;
  dq_kernel<T><<<grid_of(B, H, Tq), THREADS, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)bias, (const T*)dout,
      (const float*)lse, (const float*)delta, (T*)dq, H, Tq, Tk, Dh, scale, dr);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* bias,
                       const void* dout, const void* lse, const void* delta, void* dk,
                       void* dv, int B, int H, int Tq, int Tk, int Dh, float scale, Drop dr,
                       cudaStream_t st) {
  const size_t smem = sizeof(float) * (2 * TILE * (Dh + 1) + 2 * TILE +
                                       2 * BLOCK_ROWS * Dh + 2 * BLOCK_ROWS * TILE);
  static SmemRaised raised;
  const cudaError_t e = allow_smem(dkv_kernel<T>, smem, raised);
  if (e != cudaSuccess) return e;
  dkv_kernel<T><<<grid_of(B, H, Tk), THREADS, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)bias, (const T*)dout,
      (const float*)lse, (const float*)delta, (T*)dk, (T*)dv, H, Tq, Tk, Dh, scale, dr);
  return cudaGetLastError();
}

inline Drop make_drop(unsigned seed, unsigned thresh, float inv_keep, int q_tile, int k_tile,
                      int on, unsigned bh0) {
  Drop dr;
  dr.seed = seed;
  dr.thresh = thresh;
  dr.inv_keep = inv_keep;
  dr.q_tile = q_tile;
  dr.k_tile = k_tile;
  dr.on = on;
  dr.bh0 = bh0;
  return dr;
}

}  // namespace

extern "C" {

int stac_flash_max_head_dim() { return MAX_DH; }

const char* stac_flash_error_string(int code) {
  if (code == ERR_NO_ENCODE) return "libcuda has no cuTensorMapEncodeTiled";
  if (code == ERR_ENCODE) return "cuTensorMapEncodeTiled refused a q/k/v tensor map";
  if (code == ERR_TC_ARGS) return "the tensor-core kernels serve bf16 and fp16 at head dim 64 only";
  return cudaGetErrorString((cudaError_t)code);
}

// lse == nullptr: the inference kernel (no L, no dropout). In all three
// entry points use_tc != 0 launches the tensor-core kernel (bf16 and fp16 at
// Dh 64 only, else ERR_TC_ARGS), use_tc == 0 the CUDA-core one.
int stac_flash_fwd(const void* q, const void* k, const void* v, const void* bias, void* out,
                   void* lse, int B, int H, int Tq, int Tk, int Dh, float scale,
                   unsigned seed, unsigned thresh, float inv_keep, int q_tile, int k_tile,
                   int drop, unsigned bh0, int dtype, void* stream, int use_tc) {
  if (Dh <= 0 || Dh > MAX_DH || B * H <= 0 || Tq <= 0 || Tk <= 0)
    return (int)cudaErrorInvalidValue;
  if (use_tc && !((dtype == BF16 || dtype == F16) && Dh == tc::DH)) return ERR_TC_ARGS;
  const Drop dr = make_drop(seed, thresh, inv_keep, q_tile, k_tile, drop && lse != nullptr, bh0);
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case F32:
      return launch_fwd_simt<float>(q, k, v, bias, out, lse, B, H, Tq, Tk, Dh, scale, dr, st);
    case BF16:
      if (use_tc)
        return launch_fwd_tc<__nv_bfloat16>(q, k, v, bias, out, lse, B, H, Tq, Tk, scale, dr,
                                            st);
      return launch_fwd_simt<__nv_bfloat16>(q, k, v, bias, out, lse, B, H, Tq, Tk, Dh, scale,
                                            dr, st);
    case F16:
      if (use_tc)
        return launch_fwd_tc<__half>(q, k, v, bias, out, lse, B, H, Tq, Tk, scale, dr, st);
      return launch_fwd_simt<__half>(q, k, v, bias, out, lse, B, H, Tq, Tk, Dh, scale, dr, st);
  }
  return (int)cudaErrorInvalidValue;
}

int stac_flash_dq(const void* q, const void* k, const void* v, const void* bias,
                  const void* dout, const void* lse, const void* delta, void* dq, int B,
                  int H, int Tq, int Tk, int Dh, float scale, unsigned seed, unsigned thresh,
                  float inv_keep, int q_tile, int k_tile, int drop, unsigned bh0, int dtype,
                  void* stream, int use_tc) {
  if (Dh <= 0 || Dh > MAX_DH || B * H <= 0 || Tq <= 0 || Tk <= 0)
    return (int)cudaErrorInvalidValue;
  if (use_tc && !((dtype == BF16 || dtype == F16) && Dh == tc::DH)) return ERR_TC_ARGS;
  const Drop dr = make_drop(seed, thresh, inv_keep, q_tile, k_tile, drop, bh0);
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case F32:
      return launch_dq<float>(q, k, v, bias, dout, lse, delta, dq, B, H, Tq, Tk, Dh, scale,
                              dr, st);
    case BF16:
      if (use_tc)
        return launch_dq_tc<__nv_bfloat16>(q, k, v, bias, dout, lse, delta, dq, B, H, Tq, Tk,
                                           scale, dr, st);
      return launch_dq<__nv_bfloat16>(q, k, v, bias, dout, lse, delta, dq, B, H, Tq, Tk, Dh,
                                      scale, dr, st);
    case F16:
      if (use_tc)
        return launch_dq_tc<__half>(q, k, v, bias, dout, lse, delta, dq, B, H, Tq, Tk, scale,
                                    dr, st);
      return launch_dq<__half>(q, k, v, bias, dout, lse, delta, dq, B, H, Tq, Tk, Dh, scale,
                               dr, st);
  }
  return (int)cudaErrorInvalidValue;
}

int stac_flash_dkv(const void* q, const void* k, const void* v, const void* bias,
                   const void* dout, const void* lse, const void* delta, void* dk, void* dv,
                   int B, int H, int Tq, int Tk, int Dh, float scale, unsigned seed,
                   unsigned thresh, float inv_keep, int q_tile, int k_tile, int drop,
                   unsigned bh0, int dtype, void* stream, int use_tc) {
  if (Dh <= 0 || Dh > MAX_DH || B * H <= 0 || Tq <= 0 || Tk <= 0)
    return (int)cudaErrorInvalidValue;
  if (use_tc && !((dtype == BF16 || dtype == F16) && Dh == tc::DH)) return ERR_TC_ARGS;
  const Drop dr = make_drop(seed, thresh, inv_keep, q_tile, k_tile, drop, bh0);
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case F32:
      return launch_dkv<float>(q, k, v, bias, dout, lse, delta, dk, dv, B, H, Tq, Tk, Dh,
                               scale, dr, st);
    case BF16:
      if (use_tc)
        return launch_dkv_tc<__nv_bfloat16>(q, k, v, bias, dout, lse, delta, dk, dv, B, H, Tq,
                                            Tk, scale, dr, st);
      return launch_dkv<__nv_bfloat16>(q, k, v, bias, dout, lse, delta, dk, dv, B, H, Tq,
                                       Tk, Dh, scale, dr, st);
    case F16:
      if (use_tc)
        return launch_dkv_tc<__half>(q, k, v, bias, dout, lse, delta, dk, dv, B, H, Tq, Tk,
                                     scale, dr, st);
      return launch_dkv<__half>(q, k, v, bias, dout, lse, delta, dk, dv, B, H, Tq, Tk, Dh,
                                scale, dr, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
