// Single-step decode attention for Hopper (sm_90a): three kernels, one design.
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
//   anc:   position s of hypothesis r is read from cache row b*beam + anc[b,r,s]
//          (K and V both (BB,H,S,Dh)); the caches are never reordered;
//   cross: the beam queries of one utterance against that utterance's encoder
//          K^T (B,H,Dh,S) / V (B,H,S,Dh), stored once, plus an additive (B,S) bias.
//
// Bound: device memory. One decode step reads every cached key and value once
// and does 4*Dh flops per (query, position); at the serving shapes (bf16,
// Dh 64) that is ~1 flop per byte, far below the ~295 flop/byte where the
// tensor cores would become the limit. So the design only has to read each
// byte once: one block per (row, head) -- per (utterance, head) for cross,
// so the encoder K/V is read once for all beam queries -- scores for all
// positions kept in shared memory, an exact two-pass softmax, and no padding
// of S (the TPU kernels padded S to 128 lanes and stored fp32 only; neither
// is needed here). Launch overhead, not bandwidth, dominates the small cross
// call; making these fast (several rows per block, cp.async/TMA pipelines)
// is later work.
//
// Plain C interface, loaded with ctypes; every launcher returns the
// cudaError_t of the launch (0 = success). Kernels run on the caller's
// stream, allocate nothing and never synchronise.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int DH = 64;          // head dim of every preset (d_model / nhead)
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int GROUPS = THREADS / DH;  // position groups in the P.V pass
constexpr int MAX_BEAM = 16;    // cross kernel: queries per utterance
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

// ---- decode_self_attention: one block per (row, head) --------------------
template <typename T>
__global__ void __launch_bounds__(THREADS)
self_kernel(const T* __restrict__ q, const T* __restrict__ kT,
            const T* __restrict__ v, T* __restrict__ out, int S, int idx) {
  extern __shared__ float sc[];  // [S] scores
  __shared__ float qs[DH];
  __shared__ float red[WARPS];
  __shared__ float part[THREADS];
  const size_t bh = blockIdx.x;  // row * H + head
  const T* kp = kT + bh * DH * S;  // (Dh, S)
  const T* vp = v + bh * S * DH;   // (S, Dh)
  if (threadIdx.x < DH) qs[threadIdx.x] = to_f(q[bh * DH + threadIdx.x]);
  __syncthreads();
  const int n = idx + 1;  // only positions 0..idx are read
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

// dtype codes shared with the Python wrapper
enum DType { F32 = 0, BF16 = 1, F16 = 2 };

// Raise a kernel's dynamic shared-memory limit once, to the largest size
// asked for so far (the default cap is 48 KB including static memory).
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem, size_t* allowed) {
  if (smem <= *allowed) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) *allowed = smem;
  return e;
}

template <typename T>
cudaError_t launch_self(const void* q, const void* kT, const void* v, void* out,
                        int BB, int H, int S, int idx, cudaStream_t st) {
  const size_t smem = (size_t)S * sizeof(float);
  static size_t allowed = 0;
  cudaError_t e = allow_smem(self_kernel<T>, smem, &allowed);
  if (e != cudaSuccess) return e;
  self_kernel<T><<<BB * H, THREADS, smem, st>>>(
      (const T*)q, (const T*)kT, (const T*)v, (T*)out, S, idx);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_anc(const void* q, const void* k, const void* v, const void* anc,
                       void* out, int BB, int H, int S, int beam, int idx,
                       cudaStream_t st) {
  const size_t smem = (size_t)S * (sizeof(float) + sizeof(int));
  static size_t allowed = 0;
  cudaError_t e = allow_smem(anc_kernel<T>, smem, &allowed);
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
  static size_t allowed = 0;
  cudaError_t e = allow_smem(cross_kernel<T>, smem, &allowed);
  if (e != cudaSuccess) return e;
  cross_kernel<T><<<B * H, THREADS, smem, st>>>(
      (const T*)q, (const T*)kT, (const T*)v, (const float*)bias, (T*)out, H, S, beam);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int stac_decode_head_dim() { return DH; }
int stac_decode_max_beam() { return MAX_BEAM; }

const char* stac_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int stac_decode_self_attention(const void* q, const void* kT, const void* v, void* out,
                               int BB, int H, int S, int idx, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case F32: return launch_self<float>(q, kT, v, out, BB, H, S, idx, st);
    case BF16: return launch_self<__nv_bfloat16>(q, kT, v, out, BB, H, S, idx, st);
    case F16: return launch_self<__half>(q, kT, v, out, BB, H, S, idx, st);
  }
  return (int)cudaErrorInvalidValue;
}

int stac_decode_self_attention_anc(const void* q, const void* k, const void* v,
                                   const void* anc, void* out, int BB, int H, int S,
                                   int beam, int idx, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case F32: return launch_anc<float>(q, k, v, anc, out, BB, H, S, beam, idx, st);
    case BF16:
      return launch_anc<__nv_bfloat16>(q, k, v, anc, out, BB, H, S, beam, idx, st);
    case F16: return launch_anc<__half>(q, k, v, anc, out, BB, H, S, beam, idx, st);
  }
  return (int)cudaErrorInvalidValue;
}

int stac_decode_cross_attention(const void* q, const void* kT, const void* v,
                                const void* bias, void* out, int B, int H, int S,
                                int beam, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case F32: return launch_cross<float>(q, kT, v, bias, out, B, H, S, beam, st);
    case BF16:
      return launch_cross<__nv_bfloat16>(q, kT, v, bias, out, B, H, S, beam, st);
    case F16: return launch_cross<__half>(q, kT, v, bias, out, B, H, S, beam, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
