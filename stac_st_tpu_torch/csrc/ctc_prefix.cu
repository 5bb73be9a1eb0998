// CTC prefix scores of candidate continuations for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package computes these scores with an
// XLA lax.scan over the encoder frames inside every decode step of a joint
// CTC/attention search (stac_st_tpu/decoding/ctc_prefix.py:126,
// ctc_prefix_score_all). In PyTorch that scan would be a Python loop of
// T frames x 4-6 small kernels a decode step (about 1,000-1,500 launches a
// step at 251 frames), on a loop that is already bound by the host.
//
// For each lane (row r, candidate k), with c = cand[r, k] (or c = k when
// cand is null: the full vocabulary), x[t] = log_probs[r / beam, t, c],
// xb[t] = log_probs[r / beam, t, blank], and the row's prefix state
// r_nb, r_b (T,) and last label:
//   phi[t]  = c == last ? r_b[t] : logaddexp(r_nb[t], r_b[t])
//   phi[-1] = 0 for the empty prefix (last < 0), -1e9 otherwise
//   nb[t]   = logaddexp(nb[t-1], phi[t-1]) + x[t]     (nb[-1] = -1e9)
//   b[t]    = logaddexp(b[t-1], nb[t-1]) + xb[t]      (b[-1]  = -1e9)
//   score   = logsumexp over t of (t < len ? phi[t-1] + x[t] : -1e9)
//   score   = logaddexp(r_nb[len-1], r_b[len-1]) where c == eos,
//             -1e9 where c == blank
// and nb, b (T,) are written to the lane's row of the (BB, K, T) candidate
// state. Every value is fp32; logaddexp is max + log1p(exp(-|a - b|)), the
// formula of jnp.logaddexp (here with the MUFU exp and log, below), and
// -1e9 is a finite number, as in the reference. The posteriors stay
// (B, T, V), one per utterance: the kernel reads row r / beam, so the
// reference's repeat over the beam (803 MB of fp32 at B16 x beam 10 x 251
// x 5000) is never made.
//
// Bound: the bytes (the gathered x, the blank column, the prefix state
// read, 2 x K x T floats written per row) take about 1.6 us at the
// flagship joint search (BB 160, K 11, T 251) on an H100. Walked in order,
// a lane's frames are a chain of T dependent logaddexps (nb[t] needs
// nb[t-1]), and the search's 1,760 lanes are too few to hide it: the
// first designs were bound by that chain. This one is bound by the gather
// of the candidates' posterior columns: at stride V, each (lane, frame)
// reads a sector of its own, about 441,000 random sectors at the
// flagship shape, which a trace of the kernel puts at three quarters of
// its time with L2 flushed (tools/probe_ctc_prefix.py).
// Design: the chain is cut by a scan. Each frame is an affine map
// y -> (y + a) (+) c in the log semiring ((+) is logaddexp):
//   nb: a = x[t],  c = phi[t-1] + x[t]
//   b:  a = xb[t], c = nb[t-1] + xb[t]
// and two maps compose associatively, (a1, c1) then (a2, c2) =
// (a1 + a2, (c1 + a2) (+) c2). One warp takes a lane; the frames go in
// tiles of 32 x F, thread l of the warp owning F consecutive frames of a
// tile. Per tile and recurrence a thread folds its F maps in order,
// keeping each prefix map; the warp scans the threads' maps in five
// __shfl_up_sync rounds; each thread applies the map before its first
// frame to the value the tile started from, and then its prefix maps to
// that, so every frame's value is one more logaddexp: about F + 5 + 1
// dependent logaddexps a recurrence and tile instead of 32 x F. The b scan
// runs on the nb values. The state at a tile's last frame carries to the
// next tile, so shared memory holds one tile's worth whatever T is: a
// block (up to four of one row's candidates, a warp each) stages the
// tile's phi base (logaddexp(r_nb, r_b)), r_b and blank column once for
// all its candidates; the row's last label reads r_b. psi is the online
// (max, sum) over valid frames of phi[t-1] + x[t], the c of the nb maps,
// merged over the warp by shuffles at the end. Each warp stores its tile's nb
// and b through a shared buffer, 32 consecutive floats an instruction.
// Shuffles in a fixed order and no atomics: two launches give bitwise-equal
// results. The scan sums the x's before it adds them to a -1e9 term, where
// the reference adds them one at a time (each addition rounds away at -1e9,
// whose ulp is 64), so values in the -1e9 class differ bitwise from the plain
// version's, and others by rounding. exp and log are the MUFU forms: against
// the accurate expf and log1pf they take 64 registers, not 114, and 36 us,
// not 56, at the full vocabulary (B2 x 5000, T 251) on an H100, and the
// results stay within 1e-6 relative of the plain version at T 251.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// A probe build (tools/probe_ctc_prefix.py) may set the block's warps and
// the transcendental forms.
#ifndef STAC_CTC_WARPS
#define STAC_CTC_WARPS 4
#endif

constexpr float NEG_INF = -1.0e9f;  // the reference's finite -inf
constexpr float NONE = -1.0e30f;    // identity map: (y + 0) (+) NONE == y
constexpr int F = 8;                // frames a thread and tile
constexpr int TILE = 32 * F;        // frames a tile
constexpr int MAX_WARPS = STAC_CTC_WARPS;  // candidates a block
constexpr int PAD = TILE + TILE / F + 1;  // a staged tile of TILE + 1 frames
constexpr unsigned FULL = 0xffffffffu;

// CTC_MARK(k, dep): a probe build (-DSTAC_CTC_TRACE) records the global
// timer at point k of each block (thread 0), once ``dep`` is computed, into
// ctc_trace[block * 8 + k]; empty in the library.
#ifdef STAC_CTC_TRACE
__device__ unsigned long long* ctc_trace;
#define CTC_MARK(k, dep)                                                   \
  do {                                                                     \
    if (threadIdx.x == 0 && ctc_trace != nullptr) {                        \
      asm volatile("" ::"f"(dep) : "memory");                              \
      unsigned long long t_;                                               \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));              \
      ctc_trace[(blockIdx.y * gridDim.x + blockIdx.x) * 8 + (k)] = t_;     \
    }                                                                      \
  } while (0)
#else
#define CTC_MARK(k, dep)
#endif

// Thread l reads frames l * F .. l * F + F - 1 of a staged array; one
// padding word after every F puts them at stride F + 1, coprime with the
// 32 banks, so the warp's reads do not conflict.
__device__ __forceinline__ int pad(int j) { return j + j / F; }

// exp, and log(1 + e) for e in [0, 1]: the MUFU forms (ex2.approx and
// lg2.approx, a relative error of about 2^-21 and an absolute one of
// about 2^-21 respectively); a probe build with STAC_CTC_ACCURATE takes
// the accurate expf and log1pf
#ifdef STAC_CTC_ACCURATE
__device__ __forceinline__ float exp_(float x) { return expf(x); }
__device__ __forceinline__ float log1p_(float e) { return log1pf(e); }
#else
__device__ __forceinline__ float exp_(float x) { return __expf(x); }
__device__ __forceinline__ float log1p_(float e) { return __logf(1.f + e); }
#endif

__device__ __forceinline__ float logaddexp(float a, float b) {
  return fmaxf(a, b) + log1p_(exp_(-fabsf(a - b)));
}

// (m, s) += (m2, s2) for a sum s * exp(m) kept as a max and a scaled sum
__device__ __forceinline__ void merge(float& m, float& s, float m2,
                                      float s2) {
  if (m2 > m) {
    s = s * expf(m - m2) + s2;
    m = m2;
  } else if (m2 != -INFINITY) {
    s += s2 * expf(m2 - m);
  }
}

// Thread l holds the map (a, c) of its F frames. Returns the value before
// its first frame, given y, the value before the warp's first frame: the
// warp's inclusive scan of the maps in frame order (five rounds), then the
// maps of the threads before l applied to y.
__device__ __forceinline__ float value_before(float a, float c, float y,
                                              int l) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float a2 = __shfl_up_sync(FULL, a, off);
    const float c2 = __shfl_up_sync(FULL, c, off);
    if (l >= off) {  // (a2, c2) then (a, c)
      c = logaddexp(c2 + a, c);
      a = a2 + a;
    }
  }
  const float a1 = __shfl_up_sync(FULL, a, 1);
  const float c1 = __shfl_up_sync(FULL, c, 1);
  return l ? logaddexp(y + a1, c1) : y;
}

// Scans F frame maps (a[i], c[i]) of every thread of the warp into values
// v[i]: y is the value before the warp's first frame. Returns the value
// before this thread's first frame.
__device__ __forceinline__ float scan_frames(const float (&a)[F],
                                             const float (&c)[F], float y,
                                             int l, float (&v)[F]) {
  float pa[F], pc[F];  // the thread's prefix maps
  pa[0] = a[0];
  pc[0] = c[0];
#pragma unroll
  for (int i = 1; i < F; ++i) {
    pc[i] = logaddexp(pc[i - 1] + a[i], c[i]);
    pa[i] = pa[i - 1] + a[i];
  }
  const float y0 = value_before(pa[F - 1], pc[F - 1], y, l);
#pragma unroll
  for (int i = 0; i < F; ++i) v[i] = logaddexp(y0 + pa[i], pc[i]);
  return y0;
}

// Writes a warp's F values a thread (frames l * F + i of the tile) to
// out[t0 + j] for t0 + j < T, 32 consecutive floats an instruction,
// through the warp's shared buffer.
__device__ __forceinline__ void store_tile(const float (&v)[F], float* buf,
                                           float* out, int t0, int T, int l) {
#pragma unroll
  for (int i = 0; i < F; ++i) buf[pad(l * F + i)] = v[i];
  __syncwarp();
#pragma unroll
  for (int i = 0; i < F; ++i) {
    const int j = i * 32 + l;
    if (t0 + j < T) out[t0 + j] = buf[pad(j)];
  }
  __syncwarp();
}

__global__ void __launch_bounds__(MAX_WARPS * 32) ctc_prefix_kernel(
    const float* __restrict__ lp, const float* __restrict__ r_nb,
    const float* __restrict__ r_b, const int64_t* __restrict__ last,
    const int64_t* __restrict__ cand, const int64_t* __restrict__ lens,
    float* __restrict__ scores, float* __restrict__ nb_all,
    float* __restrict__ b_all, int K, int T, int V, int beam, int blank,
    int eos) {
  // the tile's row terms: phi[t0 + j - 1] as the phi base (stage[0]) and
  // as r_b (stage[1], the row's last label), the blank column at t0 + j
  __shared__ float stage[2][PAD];
  __shared__ float xbs[PAD];
  __shared__ float bufs[MAX_WARPS][PAD];  // a warp's values, frame order

  const int r = blockIdx.x;
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  const int k = blockIdx.y * (blockDim.x / 32) + w;
  const bool active = k < K;  // the same for the whole warp
  const int64_t lane = (int64_t)r * K + k;
  const int c = active ? (cand ? (int)cand[lane] : k) : 0;
  const float* x_row = lp + (size_t)(r / beam) * T * V;
  const float* rnb = r_nb + (size_t)r * T;
  const float* rb = r_b + (size_t)r * T;
  const int64_t lst = last[r];
  const int len = (int)lens[r];
  const float phi_m1 = lst < 0 ? 0.f : NEG_INF;
  const float* phi = stage[c == lst ? 1 : 0];
  const float* xc = x_row + c;
  float* buf = bufs[w];
  CTC_MARK(0, 0.f);

  float nb_y = NEG_INF, b_y = NEG_INF;  // the values before the tile
  float m = -INFINITY, s = 0.f;          // psi of this thread's frames
  float x[F];
#pragma unroll
  for (int i = 0; i < F; ++i) {
    const int t = l * F + i;
    x[i] = active && t < T ? __ldg(xc + (size_t)t * V) : 0.f;
  }

  for (int t0 = 0; t0 < T; t0 += TILE) {
    __syncthreads();  // every warp is done with the previous tile's terms
    for (int j = threadIdx.x; j <= TILE; j += blockDim.x) {
      const int t = t0 + j - 1;
      if (t < 0) {
        stage[0][pad(j)] = phi_m1;
        stage[1][pad(j)] = phi_m1;
      } else if (t < T) {
        const float b = __ldg(rb + t);
        stage[0][pad(j)] = logaddexp(__ldg(rnb + t), b);
        stage[1][pad(j)] = b;
      }
      if (j < TILE && t + 1 < T)
        xbs[pad(j)] = __ldg(x_row + (size_t)(t + 1) * V + blank);
    }
    __syncthreads();
    if (t0 == 0) CTC_MARK(1, stage[0][0]);
    if (active) {
      float nx[F];  // the next tile's x, in flight during this one
#pragma unroll
      for (int i = 0; i < F; ++i) {
        const int t = t0 + TILE + l * F + i;
        nx[i] = t < T ? __ldg(xc + (size_t)t * V) : 0.f;
      }
      // nb, and psi's terms phi[t-1] + x[t], the c of the nb maps; frames
      // past T are identity maps
      float a[F], cm[F], v[F];
      float pm = -INFINITY;
#pragma unroll
      for (int i = 0; i < F; ++i) {
        const int j = l * F + i, t = t0 + j;
        a[i] = x[i];
        cm[i] = t < T ? phi[pad(j)] + x[i] : NONE;
        if (t < T) pm = fmaxf(pm, t < len ? cm[i] : NEG_INF);
      }
      if (t0 == 0) CTC_MARK(2, cm[F - 1]);
      if (pm != -INFINITY) {
        float ps = 0.f;
#pragma unroll
        for (int i = 0; i < F; ++i) {
          const int t = t0 + l * F + i;
          if (t < T) ps += exp_((t < len ? cm[i] : NEG_INF) - pm);
        }
        merge(m, s, pm, ps);
      }
      const float nb0 = scan_frames(a, cm, nb_y, l, v);
      if (t0 == 0) CTC_MARK(3, v[F - 1]);
      // b, on nb[t-1]: nb0 before the thread's first frame
      float vb[F];
#pragma unroll
      for (int i = 0; i < F; ++i) {
        const int j = l * F + i, t = t0 + j;
        const float xb = t < T ? xbs[pad(j)] : 0.f;
        cm[i] = t < T ? (i ? v[i - 1] : nb0) + xb : NONE;
        a[i] = xb;
      }
      scan_frames(a, cm, b_y, l, vb);
      if (t0 == 0) CTC_MARK(4, vb[F - 1]);
      nb_y = __shfl_sync(FULL, v[F - 1], 31);
      b_y = __shfl_sync(FULL, vb[F - 1], 31);
      store_tile(v, buf, nb_all + (size_t)lane * T, t0, T, l);
      store_tile(vb, buf, b_all + (size_t)lane * T, t0, T, l);
      if (t0 == 0) CTC_MARK(5, 0.f);
#pragma unroll
      for (int i = 0; i < F; ++i) x[i] = nx[i];
    }
  }

  CTC_MARK(6, 0.f);
  if (active) {
#pragma unroll
    for (int off = 16; off; off >>= 1) {
      const float m2 = __shfl_xor_sync(FULL, m, off);
      const float s2 = __shfl_xor_sync(FULL, s, off);
      merge(m, s, m2, s2);
    }
    if (l == 0) {
      float score = m + logf(s);
      if (c == eos) {  // the whole prefix: logaddexp(r_nb, r_b) at len - 1
        const int i = len - 1 < 0 ? 0 : len - 1 < T ? len - 1 : T - 1;
        score = logaddexp(__ldg(rnb + i), __ldg(rb + i));
      }
      if (c == blank) score = NEG_INF;
      scores[lane] = score;
      CTC_MARK(7, score);
    }
  }
}

}  // namespace

extern "C" {

const char* stac_ctc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

#ifdef STAC_CTC_TRACE
int stac_ctc_set_trace(void* p) {
  return (int)cudaMemcpyToSymbol(ctc_trace, &p, sizeof(p));
}
#endif

// log_probs (B, T, V) fp32; r_nb, r_b (BB, T) fp32; last (BB,) int64;
// cand (BB, K) int64 or null (K == V, candidate k is token k); lens (BB,)
// int64; outputs scores (BB, K), nb_all and b_all (BB, K, T), fp32. All
// contiguous; any T. Returns the launch's cudaError_t.
int stac_ctc_prefix_score(const float* lp, const float* r_nb,
                          const float* r_b, const int64_t* last,
                          const int64_t* cand, const int64_t* lens,
                          float* scores, float* nb_all, float* b_all,
                          int BB, int K, int T, int V, int beam, int blank,
                          int eos, cudaStream_t stream) {
  if (BB == 0 || K == 0 || T == 0) return (int)cudaSuccess;
  const int warps = K < MAX_WARPS ? K : MAX_WARPS;
  const dim3 grid(BB, (K + warps - 1) / warps);
  ctc_prefix_kernel<<<grid, 32 * warps, 0, stream>>>(
      lp, r_nb, r_b, last, cand, lens, scores, nb_all, b_all, K, T, V, beam,
      blank, eos);
  return (int)cudaGetLastError();
}

}  // extern "C"
