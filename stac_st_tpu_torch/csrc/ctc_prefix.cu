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
// formula of jnp.logaddexp, and -1e9 is a finite number, as in the
// reference. The posteriors stay (B, T, V), one per utterance: the kernel
// reads row r / beam, so the reference's repeat over the beam (803 MB of
// fp32 at B16 x beam 10 x 251 x 5000) is never made.
//
// Bound: latency. Each lane's frames form a chain of T dependent steps
// (nb[t] needs nb[t-1]); the bytes (the gathered x, the blank column, the
// prefix state read, 2 x K x T floats written per row) take about 1.6 us
// at the flagship joint search (BB 160, K 11, T 251) on an H100. The
// flagship search has 1,760 lanes, 55 warps' worth, so nothing hides a
// chain warp's latency: what sets the time is how much a step waits on.
// Design: one block a (row, group of up to 32 candidates), four warps.
// All of them first stage the row's phi base (logaddexp(r_nb, r_b), shared
// by every candidate but the row's last label, which reads r_b), r_b and
// the blank column in shared memory. Then warp 0 runs the chains alone,
// one thread a candidate, the x loads a chunk of CHUNK frames ahead in
// registers, so a step is two logaddexps on operands already in registers
// or shared memory; warps 1-3 meanwhile reduce each candidate's psi
// (threads over frames, an online (max, sum) merged by shuffles in a fixed
// order). No atomics: two launches give bitwise-equal results. The nb and
// b values are the same fp32 operations in the same order as the plain
// version's; psi sums in another order.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1.0e9f;
constexpr int CHUNK = 8;
constexpr int GROUP = 32;    // candidates a block: the chain warp's threads
constexpr int THREADS = 128;  // the chain warp and three psi warps
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float logaddexp(float a, float b) {
  return fmaxf(a, b) + log1pf(expf(-fabsf(a - b)));
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

__global__ void __launch_bounds__(THREADS) ctc_prefix_kernel(
    const float* __restrict__ lp, const float* __restrict__ r_nb,
    const float* __restrict__ r_b, const int64_t* __restrict__ last,
    const int64_t* __restrict__ cand, const int64_t* __restrict__ lens,
    float* __restrict__ scores, float* __restrict__ nb_all,
    float* __restrict__ b_all, int K, int T, int V, int beam, int blank,
    int eos) {
  extern __shared__ float smem[];  // phi base, r_b, the blank column
  float* phi_base = smem;
  float* rbs = smem + T;
  float* xbs = smem + 2 * T;
  __shared__ float psi[GROUP];

  const int r = blockIdx.x;
  const int k0 = blockIdx.y * GROUP;
  const int n_lanes = K - k0 < GROUP ? K - k0 : GROUP;
  const float* x_row = lp + (size_t)(r / beam) * T * V;
  const float* rnb = r_nb + (size_t)r * T;
  const float* rb = r_b + (size_t)r * T;
  const int64_t lst = last[r];
  const int len = (int)lens[r];
  const float phi_m1 = lst < 0 ? 0.f : NEG_INF;

  for (int t = threadIdx.x; t < T; t += THREADS) {
    const float b = __ldg(rb + t);
    phi_base[t] = logaddexp(__ldg(rnb + t), b);
    rbs[t] = b;
    xbs[t] = __ldg(x_row + (size_t)t * V + blank);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int l = threadIdx.x % 32;
  if (warp == 0) {
    if (l < n_lanes) {
      const int64_t lane = (int64_t)r * K + k0 + l;
      const int c = cand ? (int)cand[lane] : k0 + l;
      const float* phi = c == lst ? rbs : phi_base;
      const float* xc = x_row + c;
      float* out_nb = nb_all + (size_t)lane * T;
      float* out_b = b_all + (size_t)lane * T;
      float nb = NEG_INF, b = NEG_INF, phi_prev = phi_m1;
      float x[CHUNK];
#pragma unroll
      for (int j = 0; j < CHUNK; ++j)
        if (j < T) x[j] = __ldg(xc + (size_t)j * V);
      for (int t0 = 0; t0 < T; t0 += CHUNK) {
        float nx[CHUNK];
#pragma unroll
        for (int j = 0; j < CHUNK; ++j) {
          const int t = t0 + CHUNK + j;
          if (t < T) nx[j] = __ldg(xc + (size_t)t * V);
        }
#pragma unroll
        for (int j = 0; j < CHUNK; ++j) {
          const int t = t0 + j;
          if (t < T) {
            const float nb_t = logaddexp(nb, phi_prev) + x[j];
            const float b_t = logaddexp(b, nb) + xbs[t];
            out_nb[t] = nb_t;
            out_b[t] = b_t;
            nb = nb_t;
            b = b_t;
            phi_prev = phi[t];
          }
        }
#pragma unroll
        for (int j = 0; j < CHUNK; ++j) x[j] = nx[j];
      }
    }
  } else {
    // psi: warp w takes candidates w - 1, w + 2, ...; its threads split
    // the frames and merge their (max, sum) pairs by shuffles
    for (int kk = warp - 1; kk < n_lanes; kk += THREADS / 32 - 1) {
      const int c = cand ? (int)cand[(int64_t)r * K + k0 + kk] : k0 + kk;
      const float* phi = c == lst ? rbs : phi_base;
      float m = -INFINITY, s = 0.f;
      for (int t = l; t < T; t += 32) {
        const float pp = t ? phi[t - 1] : phi_m1;
        const float term =
            t < len ? pp + __ldg(x_row + (size_t)t * V + c) : NEG_INF;
        merge(m, s, term, 1.f);
      }
#pragma unroll
      for (int off = 16; off; off >>= 1) {
        const float m2 = __shfl_xor_sync(FULL, m, off);
        const float s2 = __shfl_xor_sync(FULL, s, off);
        merge(m, s, m2, s2);
      }
      if (l == 0) psi[kk] = m + logf(s);
    }
  }
  __syncthreads();

  if (warp == 0 && l < n_lanes) {
    const int64_t lane = (int64_t)r * K + k0 + l;
    const int c = cand ? (int)cand[lane] : k0 + l;
    float score = psi[l];
    // eos: the whole prefix, logaddexp(r_nb, r_b) at len - 1
    if (c == eos) score = phi_base[len - 1 > 0 ? len - 1 : 0];
    if (c == blank) score = NEG_INF;
    scores[lane] = score;
  }
}

}  // namespace

extern "C" {

const char* stac_ctc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int stac_ctc_max_frames() { return (48 * 1024) / (3 * (int)sizeof(float)); }

// log_probs (B, T, V) fp32; r_nb, r_b (BB, T) fp32; last (BB,) int64;
// cand (BB, K) int64 or null (K == V, candidate k is token k); lens (BB,)
// int64; outputs scores (BB, K), nb_all and b_all (BB, K, T), fp32. All
// contiguous; T <= stac_ctc_max_frames(). Returns the launch's
// cudaError_t.
int stac_ctc_prefix_score(const float* lp, const float* r_nb,
                          const float* r_b, const int64_t* last,
                          const int64_t* cand, const int64_t* lens,
                          float* scores, float* nb_all, float* b_all,
                          int BB, int K, int T, int V, int beam, int blank,
                          int eos, cudaStream_t stream) {
  if (BB == 0 || K == 0 || T == 0) return (int)cudaSuccess;
  const dim3 grid(BB, (K + GROUP - 1) / GROUP);
  ctc_prefix_kernel<<<grid, THREADS, 3 * T * sizeof(float), stream>>>(
      lp, r_nb, r_b, last, cand, lens, scores, nb_all, b_all, K, T, V, beam,
      blank, eos);
  return (int)cudaGetLastError();
}

}  // extern "C"
