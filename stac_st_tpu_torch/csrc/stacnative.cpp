// stacnative — the port's native host runtime, a shared library with a
// plain C interface, loaded with ctypes (stac_st_tpu_torch/native.py).
//
// The host paths that the reference hands to native libraries: audio
// decode (PCM16 in either byte order, G.711 µ-law and A-law: every prep
// script and loader worker), polyphase resampling, SentencePiece's BPE
// merge loop (every utterance is tokenized) and the Levenshtein core of WER
// scoring. Built with the host C++ compiler at first use; ctypes releases
// the interpreter lock around every call, so loader threads run these
// loops in parallel.
//
// Each function mirrors a numpy or pure-Python version of the port
// (native.py names them); the tests hold the two to each other.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <queue>
#include <string>
#include <tuple>
#include <unordered_map>
#include <vector>

namespace {

// ------------------------------------------------------------------ audio

// µ-law expansion (G.711), the numpy version's formula.
inline int16_t ulaw_to_pcm16(uint8_t u) {
  u = ~u;
  int sign = u & 0x80;
  int exponent = (u >> 4) & 0x07;
  int mantissa = u & 0x0F;
  int sample = ((mantissa << 3) + 0x84) << exponent;
  sample -= 0x84;
  return static_cast<int16_t>(sign ? -sample : sample);
}

inline int16_t alaw_to_pcm16(uint8_t a) {
  a ^= 0x55;
  int sign = a & 0x80;
  int exponent = (a >> 4) & 0x07;
  int mantissa = a & 0x0F;
  int sample = exponent == 0 ? (mantissa << 4) + 8
                             : ((mantissa << 4) + 0x108)
                                   << (exponent > 1 ? exponent - 1 : 0);
  return static_cast<int16_t>(sign ? -sample : sample);
}

double bessel_i0(double x) {
  double sum = 1.0, term = 1.0;
  for (int k = 1; k < 64; ++k) {
    term *= (x / (2.0 * k)) * (x / (2.0 * k));
    sum += term;
    if (term < 1e-16 * sum) break;
  }
  return sum;
}

// ------------------------------------------------------------ BPE encode

struct BpeVocab {
  std::unordered_map<std::string, int> piece_to_id;
  std::unordered_map<std::string, double> scores;
};

inline size_t utf8_len(uint8_t c) {
  if (c >= 0xF0) return 4;
  if (c >= 0xE0) return 3;
  if (c >= 0xC0) return 2;
  return 1;
}

// Greedy highest-score pair merging (SentencePiece's bpe_model), one
// normalized segment with no user-defined symbol inside; the pure-Python
// BpeEncoder._bpe_segment_plain step for step: a heap of (-score,
// position, merged piece), stale entries skipped, unknown pieces emitted
// per character.
void bpe_segment(const BpeVocab& vocab, const std::string& text, int unk_id,
                 std::vector<int32_t>* out) {
  std::vector<std::string> syms;
  for (size_t i = 0; i < text.size();) {
    const size_t len = utf8_len(static_cast<uint8_t>(text[i]));
    syms.push_back(text.substr(i, len));
    i += len;
  }
  const int n = static_cast<int>(syms.size());
  if (n == 0) return;
  std::vector<int> nxt(n), prv(n);
  std::vector<char> alive(n, 1);
  for (int i = 0; i < n; ++i) {
    nxt[i] = i + 1;
    prv[i] = i - 1;
  }
  using Entry = std::tuple<double, int, std::string>;
  std::priority_queue<Entry, std::vector<Entry>, std::greater<Entry>> heap;
  auto push = [&](int i) {
    const int j = nxt[i];
    if (j >= n) return;
    std::string merged = syms[i] + syms[j];
    auto it = vocab.scores.find(merged);
    if (it != vocab.scores.end()) heap.emplace(-it->second, i, std::move(merged));
  };
  for (int i = 0; i < n - 1; ++i) push(i);
  while (!heap.empty()) {
    const auto [neg, i, merged] = heap.top();
    heap.pop();
    if (!alive[i]) continue;
    const int j = nxt[i];
    if (j >= n || !alive[j] || syms[i] + syms[j] != merged) continue;
    syms[i] = merged;
    alive[j] = 0;
    nxt[i] = nxt[j];
    if (nxt[i] < n) prv[nxt[i]] = i;
    push(i);
    if (prv[i] >= 0) push(prv[i]);
  }
  for (int i = 0; i < n; i = nxt[i]) {
    auto it = vocab.piece_to_id.find(syms[i]);
    if (it != vocab.piece_to_id.end()) {
      out->push_back(it->second);
      continue;
    }
    const std::string& s = syms[i];
    for (size_t k = 0; k < s.size();) {
      const size_t len = utf8_len(static_cast<uint8_t>(s[k]));
      auto cit = vocab.piece_to_id.find(s.substr(k, len));
      out->push_back(cit != vocab.piece_to_id.end() ? cit->second : unk_id);
      k += len;
    }
  }
}

}  // namespace

extern "C" {

// n int16 samples (2n bytes) -> n float32 in [-1, 1)
void stac_pcm16_to_float(const uint8_t* src, int64_t n, int big_endian,
                         float* dst) {
  for (int64_t i = 0; i < n; ++i) {
    const int16_t v =
        big_endian
            ? static_cast<int16_t>((src[2 * i] << 8) | src[2 * i + 1])
            : static_cast<int16_t>(src[2 * i] | (src[2 * i + 1] << 8));
    dst[i] = static_cast<float>(v) / 32768.0f;
  }
}

void stac_ulaw_to_float(const uint8_t* src, int64_t n, float* dst) {
  for (int64_t i = 0; i < n; ++i)
    dst[i] = static_cast<float>(ulaw_to_pcm16(src[i])) / 32768.0f;
}

void stac_alaw_to_float(const uint8_t* src, int64_t n, float* dst) {
  for (int64_t i = 0; i < n; ++i)
    dst[i] = static_cast<float>(alaw_to_pcm16(src[i])) / 32768.0f;
}

// Output length of stac_resample_poly: ceil(n_in * up / down).
int64_t stac_resample_poly_len(int64_t n_in, int up, int down) {
  return (n_in * up + down - 1) / down;
}

// Kaiser-windowed-sinc polyphase resampler (scipy's resample_poly family:
// cutoff at 1 / max(up, down), Kaiser beta 5, ten zero crossings a phase).
void stac_resample_poly(const float* x, int64_t n_in, int up, int down,
                        float* y) {
  const int half = 10 * std::max(up, down);
  const int ntaps = 2 * half + 1;
  const double cutoff = 0.5 / std::max(up, down);
  const double beta = 5.0;
  std::vector<double> h(ntaps);
  const double i0b = bessel_i0(beta);
  for (int i = 0; i < ntaps; ++i) {
    const double m = i - half;
    const double sinc =
        (m == 0) ? 2.0 * cutoff : std::sin(2.0 * M_PI * cutoff * m) / (M_PI * m);
    const double r = m / half;
    const double w =
        bessel_i0(beta * std::sqrt(std::max(0.0, 1.0 - r * r))) / i0b;
    h[i] = sinc * w * up;
  }
  const int64_t n_out = stac_resample_poly_len(n_in, up, down);
  for (int64_t j = 0; j < n_out; ++j) {
    // output sample j draws from upsampled index j * down; x[k] contributes
    // through h[t - k * up + half]
    const int64_t t = j * down;
    int64_t k_lo = (t - half + up - 1) / up;
    int64_t k_hi = (t + half) / up;
    if (k_lo < 0) k_lo = 0;
    if (k_hi >= n_in) k_hi = n_in - 1;
    double acc = 0.0;
    for (int64_t k = k_lo; k <= k_hi; ++k)
      acc += static_cast<double>(x[k]) * h[t - k * up + half];
    y[j] = static_cast<float>(acc);
  }
}

// Word-level Levenshtein over word ids: out = (insertions, deletions,
// substitutions) of one minimal alignment.
void stac_edit_stats(const int32_t* ref, int64_t n, const int32_t* hyp,
                     int64_t m, int32_t* out) {
  struct Cell { int32_t d, i, del, s; };
  std::vector<Cell> prev(m + 1), cur(m + 1);
  for (int64_t j = 0; j <= m; ++j)
    prev[j] = {static_cast<int32_t>(j), static_cast<int32_t>(j), 0, 0};
  for (int64_t i = 1; i <= n; ++i) {
    cur[0] = {static_cast<int32_t>(i), 0, static_cast<int32_t>(i), 0};
    for (int64_t j = 1; j <= m; ++j) {
      const bool eq = ref[i - 1] == hyp[j - 1];
      const Cell& diag = prev[j - 1];
      const Cell& up = prev[j];
      const Cell& left = cur[j - 1];
      Cell best = {diag.d + (eq ? 0 : 1), diag.i, diag.del,
                   diag.s + (eq ? 0 : 1)};
      if (left.d + 1 < best.d) best = {left.d + 1, left.i + 1, left.del, left.s};
      if (up.d + 1 < best.d) best = {up.d + 1, up.i, up.del + 1, up.s};
      cur[j] = best;
    }
    std::swap(prev, cur);
  }
  out[0] = prev[m].i;
  out[1] = prev[m].del;
  out[2] = prev[m].s;
}

// A vocabulary of n pieces (UTF-8, NUL-terminated) and their scores; the
// first occurrence of a piece keeps its id. Freed by stac_bpe_free.
void* stac_bpe_load(const char* const* pieces, const double* scores,
                    int64_t n) {
  auto* vocab = new BpeVocab();
  for (int64_t i = 0; i < n; ++i) {
    std::string piece(pieces[i]);
    if (!vocab->piece_to_id.count(piece)) {
      vocab->piece_to_id[piece] = static_cast<int>(i);
      vocab->scores[piece] = scores[i];
    }
  }
  return vocab;
}

void stac_bpe_free(void* handle) { delete static_cast<BpeVocab*>(handle); }

// Encodes one segment of len bytes into out (room for len ids: a segment
// never has more ids than bytes); returns the number of ids written.
int64_t stac_bpe_encode(const void* handle, const char* text, int64_t len,
                        int unk_id, int32_t* out) {
  std::vector<int32_t> ids;
  bpe_segment(*static_cast<const BpeVocab*>(handle), std::string(text, len),
              unk_id, &ids);
  std::copy(ids.begin(), ids.end(), out);
  return static_cast<int64_t>(ids.size());
}

}  // extern "C"
