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
// inside the kernels: keep(i, j) is a murmur3-fmix32 hash of (seed, b*H + h,
// and the coordinates of (i, j) in the reference's logical tiling: one tile
// of ceil8(T) rows when that is <= 512, else 128-row tiles), so forward and
// backward regenerate the same mask and nothing is stored. The hash is the
// reference's counter path (_dropout_mask, train_attention.py:51-92), bit
// for bit; the tile sizes come from the wrapper.
//
// Bound: at the training shapes (Tq, Tk <= a few hundred, Dh 64) each kernel
// does 4-8 flops per byte it must move, below the ~295 flop/byte ridge of
// the bf16 tensor cores, so the least time is set by device memory. This
// first design keeps every intermediate (scores, probabilities, dS) out of
// device memory, reads Q/K/V/dO once per block, and computes on the fp32
// CUDA cores from shared-memory tiles: 4 warps per block, 8 query (or key)
// rows per warp, 32-key (or 32-query) tiles with one lane per key, an
// odd row stride so lanes never share a bank. It is simple and right;
// tensor-core (wgmma) tiles and TMA pipelines are later work.
//
// The dQ / dK-dV split is the reference's own: each block owns its output
// rows, so there are no cross-block reductions and no atomics, and the
// gradients are deterministic.
//
// Plain C interface, loaded with ctypes; every launcher returns the
// cudaError_t of its launch (0 = success). Kernels run on the caller's
// stream, allocate nothing and never synchronise.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
};

// keep(i, j) / (1 - p) for query row i, key j of head bh.
__device__ __forceinline__ float keep_scale(const Drop& dr, uint32_t bh, int i, int j) {
  const uint32_t qt = (uint32_t)(i / dr.q_tile), row = (uint32_t)(i % dr.q_tile);
  const uint32_t kt = (uint32_t)(j / dr.k_tile), col = (uint32_t)(j % dr.k_tile);
  uint32_t x = (dr.seed * 0x9E3779B1u) ^ ((bh + 1u) * 0x85EBCA6Bu) ^
               ((qt + 1u) * 0xC2B2AE35u) ^ ((kt + 1u) * 0x27D4EB2Fu);
  x = x + row * 0x01000193u + col * 0x0000F1A7u;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x >= dr.thresh ? dr.inv_keep : 0.f;
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

// Raise a kernel's dynamic shared-memory limit once, to the largest size
// asked for so far (the default cap is 48 KB).
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem, size_t* allowed) {
  if (smem <= *allowed) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) *allowed = smem;
  return e;
}

inline dim3 grid_of(int B, int H, int T) {
  return dim3((unsigned)(B * H), (unsigned)((T + BLOCK_ROWS - 1) / BLOCK_ROWS));
}

template <typename T>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const void* bias,
                       void* out, void* lse, int B, int H, int Tq, int Tk, int Dh,
                       float scale, Drop dr, cudaStream_t st) {
  const size_t smem =
      sizeof(float) * (2 * TILE * (Dh + 1) + BLOCK_ROWS * Dh + BLOCK_ROWS * TILE);
  cudaError_t e;
  if (lse != nullptr) {
    static size_t allowed = 0;
    e = allow_smem(fwd_kernel<T, true>, smem, &allowed);
    if (e != cudaSuccess) return e;
    fwd_kernel<T, true><<<grid_of(B, H, Tq), THREADS, smem, st>>>(
        (const T*)q, (const T*)k, (const T*)v, (const float*)bias, (T*)out, (float*)lse, H,
        Tq, Tk, Dh, scale, dr);
  } else {
    static size_t allowed = 0;
    e = allow_smem(fwd_kernel<T, false>, smem, &allowed);
    if (e != cudaSuccess) return e;
    fwd_kernel<T, false><<<grid_of(B, H, Tq), THREADS, smem, st>>>(
        (const T*)q, (const T*)k, (const T*)v, (const float*)bias, (T*)out, nullptr, H, Tq,
        Tk, Dh, scale, dr);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* bias,
                      const void* dout, const void* lse, const void* delta, void* dq, int B,
                      int H, int Tq, int Tk, int Dh, float scale, Drop dr, cudaStream_t st) {
  const size_t smem =
      sizeof(float) * (2 * TILE * (Dh + 1) + 2 * BLOCK_ROWS * Dh + BLOCK_ROWS * TILE);
  static size_t allowed = 0;
  const cudaError_t e = allow_smem(dq_kernel<T>, smem, &allowed);
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
  static size_t allowed = 0;
  const cudaError_t e = allow_smem(dkv_kernel<T>, smem, &allowed);
  if (e != cudaSuccess) return e;
  dkv_kernel<T><<<grid_of(B, H, Tk), THREADS, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)bias, (const T*)dout,
      (const float*)lse, (const float*)delta, (T*)dk, (T*)dv, H, Tq, Tk, Dh, scale, dr);
  return cudaGetLastError();
}

inline Drop make_drop(unsigned seed, unsigned thresh, float inv_keep, int q_tile, int k_tile,
                      int on) {
  Drop dr;
  dr.seed = seed;
  dr.thresh = thresh;
  dr.inv_keep = inv_keep;
  dr.q_tile = q_tile;
  dr.k_tile = k_tile;
  dr.on = on;
  return dr;
}

}  // namespace

extern "C" {

int stac_flash_max_head_dim() { return MAX_DH; }

const char* stac_flash_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// lse == nullptr: the inference kernel (no L, no dropout).
int stac_flash_fwd(const void* q, const void* k, const void* v, const void* bias, void* out,
                   void* lse, int B, int H, int Tq, int Tk, int Dh, float scale,
                   unsigned seed, unsigned thresh, float inv_keep, int q_tile, int k_tile,
                   int drop, int dtype, void* stream) {
  if (Dh <= 0 || Dh > MAX_DH || B * H <= 0 || Tq <= 0 || Tk <= 0)
    return (int)cudaErrorInvalidValue;
  const Drop dr = make_drop(seed, thresh, inv_keep, q_tile, k_tile, drop && lse != nullptr);
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case F32: return launch_fwd<float>(q, k, v, bias, out, lse, B, H, Tq, Tk, Dh, scale, dr, st);
    case BF16:
      return launch_fwd<__nv_bfloat16>(q, k, v, bias, out, lse, B, H, Tq, Tk, Dh, scale, dr,
                                       st);
    case F16:
      return launch_fwd<__half>(q, k, v, bias, out, lse, B, H, Tq, Tk, Dh, scale, dr, st);
  }
  return (int)cudaErrorInvalidValue;
}

int stac_flash_dq(const void* q, const void* k, const void* v, const void* bias,
                  const void* dout, const void* lse, const void* delta, void* dq, int B,
                  int H, int Tq, int Tk, int Dh, float scale, unsigned seed, unsigned thresh,
                  float inv_keep, int q_tile, int k_tile, int drop, int dtype, void* stream) {
  if (Dh <= 0 || Dh > MAX_DH || B * H <= 0 || Tq <= 0 || Tk <= 0)
    return (int)cudaErrorInvalidValue;
  const Drop dr = make_drop(seed, thresh, inv_keep, q_tile, k_tile, drop);
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case F32:
      return launch_dq<float>(q, k, v, bias, dout, lse, delta, dq, B, H, Tq, Tk, Dh, scale,
                              dr, st);
    case BF16:
      return launch_dq<__nv_bfloat16>(q, k, v, bias, dout, lse, delta, dq, B, H, Tq, Tk, Dh,
                                      scale, dr, st);
    case F16:
      return launch_dq<__half>(q, k, v, bias, dout, lse, delta, dq, B, H, Tq, Tk, Dh, scale,
                               dr, st);
  }
  return (int)cudaErrorInvalidValue;
}

int stac_flash_dkv(const void* q, const void* k, const void* v, const void* bias,
                   const void* dout, const void* lse, const void* delta, void* dk, void* dv,
                   int B, int H, int Tq, int Tk, int Dh, float scale, unsigned seed,
                   unsigned thresh, float inv_keep, int q_tile, int k_tile, int drop,
                   int dtype, void* stream) {
  if (Dh <= 0 || Dh > MAX_DH || B * H <= 0 || Tq <= 0 || Tk <= 0)
    return (int)cudaErrorInvalidValue;
  const Drop dr = make_drop(seed, thresh, inv_keep, q_tile, k_tile, drop);
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case F32:
      return launch_dkv<float>(q, k, v, bias, dout, lse, delta, dk, dv, B, H, Tq, Tk, Dh,
                               scale, dr, st);
    case BF16:
      return launch_dkv<__nv_bfloat16>(q, k, v, bias, dout, lse, delta, dk, dv, B, H, Tq,
                                       Tk, Dh, scale, dr, st);
    case F16:
      return launch_dkv<__half>(q, k, v, bias, dout, lse, delta, dk, dv, B, H, Tq, Tk, Dh,
                                scale, dr, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
