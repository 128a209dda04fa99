// rANS entropy codec with a quantized-Gaussian symbol model: the port's
// copy of boosting_nerv_tpu/compress/csrc/rans.cpp, the same code, so the
// two packages emit the same stream words for the same symbols.
//
// It stands in for the reference's `constriction` coder (AnsCoder
// encode_reverse with a QuantizedGaussian(min, max, mean, std) model).
// Host-side only: the card produces the quantized integer codes; the
// bitstream is emitted on the CPU.
//
// Layout: 64-bit state, 32-bit stream words, 16-bit probability precision.
// encode() consumes symbols in reverse so decode() replays them forward,
// matching the stack (LIFO) AnsCoder convention.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <utility>
#include <vector>

namespace {

constexpr int PROB_BITS = 16;
constexpr uint32_t PROB_SCALE = 1u << PROB_BITS;
constexpr uint64_t RANS_L = 1ull << 31;  // normalised interval lower bound

double norm_cdf(double x) { return 0.5 * (1.0 + std::erf(x / std::sqrt(2.0))); }

// Quantize the Gaussian pmf over [min_v, max_v] to PROB_SCALE with every
// symbol's frequency >= 1 (largest-remainder apportionment).
void build_model(int32_t min_v, int32_t max_v, double mean, double stdv,
                 std::vector<uint32_t>& freq, std::vector<uint32_t>& cum) {
  const int n = max_v - min_v + 1;
  std::vector<double> p(n);
  double total = 0.0;
  for (int i = 0; i < n; ++i) {
    const double s = min_v + i;
    double pi = norm_cdf((s + 0.5 - mean) / stdv) - norm_cdf((s - 0.5 - mean) / stdv);
    if (pi < 1e-12) pi = 1e-12;
    p[i] = pi;
    total += pi;
  }
  freq.assign(n, 1);                     // every symbol codable
  uint32_t assigned = static_cast<uint32_t>(n);
  std::vector<std::pair<double, int>> rema(n);
  for (int i = 0; i < n; ++i) {
    const double ideal = p[i] / total * PROB_SCALE;
    uint32_t f = ideal > 1.0 ? static_cast<uint32_t>(ideal) : 1u;
    assigned += f - freq[i];
    freq[i] = f;
    rema[i] = {ideal - f, i};
  }
  // distribute (or claw back) the remainder
  if (assigned < PROB_SCALE) {
    std::sort(rema.begin(), rema.end(),
              [](auto& a, auto& b) { return a.first > b.first; });
    uint32_t left = PROB_SCALE - assigned;
    for (uint32_t k = 0; left > 0; k = (k + 1) % n, --left) freq[rema[k].second] += 1;
  } else if (assigned > PROB_SCALE) {
    std::sort(rema.begin(), rema.end(),
              [](auto& a, auto& b) { return a.first < b.first; });
    uint32_t over = assigned - PROB_SCALE;
    for (uint32_t k = 0; over > 0; k = (k + 1) % n) {
      int i = rema[k].second;
      if (freq[i] > 1) { freq[i] -= 1; --over; }
    }
  }
  cum.assign(n + 1, 0);
  for (int i = 0; i < n; ++i) cum[i + 1] = cum[i] + freq[i];
}

}  // namespace

extern "C" {

// Encode n symbols; returns stream length in 32-bit words (<= out_cap), or
// -1 if out_buf is too small. Bit count = 32 * return value.
long rans_gaussian_encode(const int32_t* symbols, long n, double mean,
                          double stdv, int32_t min_v, int32_t max_v,
                          uint32_t* out_buf, long out_cap) {
  std::vector<uint32_t> freq, cum;
  build_model(min_v, max_v, mean, stdv, freq, cum);

  std::vector<uint32_t> words;
  words.reserve(static_cast<size_t>(n) / 2 + 4);
  uint64_t x = RANS_L;
  for (long i = n - 1; i >= 0; --i) {  // encode_reverse
    int32_t s = symbols[i];
    if (s < min_v) s = min_v;
    if (s > max_v) s = max_v;
    const uint32_t f = freq[s - min_v];
    const uint32_t c = cum[s - min_v];
    const uint64_t x_max = ((RANS_L >> PROB_BITS) << 32) * f;
    if (x >= x_max) {
      words.push_back(static_cast<uint32_t>(x));
      x >>= 32;
    }
    x = ((x / f) << PROB_BITS) + (x % f) + c;
  }
  // flush state (2 words) — stream stored newest-first for forward decode
  const long total = static_cast<long>(words.size()) + 2;
  if (total > out_cap) return -1;
  out_buf[0] = static_cast<uint32_t>(x >> 32);
  out_buf[1] = static_cast<uint32_t>(x);
  for (size_t i = 0; i < words.size(); ++i)
    out_buf[2 + i] = words[words.size() - 1 - i];
  return total;
}

// Decode n symbols from a stream produced by rans_gaussian_encode.
// Returns 0 on success.
long rans_gaussian_decode(const uint32_t* buf, long nwords, long n,
                          double mean, double stdv, int32_t min_v,
                          int32_t max_v, int32_t* out_symbols) {
  std::vector<uint32_t> freq, cum;
  build_model(min_v, max_v, mean, stdv, freq, cum);
  const int nsym = max_v - min_v + 1;

  if (nwords < 2) return -1;
  uint64_t x = (static_cast<uint64_t>(buf[0]) << 32) | buf[1];
  long pos = 2;
  for (long i = 0; i < n; ++i) {
    const uint32_t slot = static_cast<uint32_t>(x & (PROB_SCALE - 1));
    // binary search: largest s with cum[s] <= slot
    int lo = 0, hi = nsym;
    while (hi - lo > 1) {
      const int mid = (lo + hi) / 2;
      if (cum[mid] <= slot) lo = mid; else hi = mid;
    }
    out_symbols[i] = min_v + lo;
    x = freq[lo] * (x >> PROB_BITS) + slot - cum[lo];
    if (x < RANS_L && pos < nwords) {
      x = (x << 32) | buf[pos++];
    }
  }
  return 0;
}

// ---- categorical model (explicit frequency table) --------------------- //
// Parity with the reference's categorical path
// (lib/entropy_model.py:65-81): symbols are indices 0..n_sym-1 with an
// empirical probability table.

namespace {

void build_categorical(const double* probs, int n_sym,
                       std::vector<uint32_t>& freq,
                       std::vector<uint32_t>& cum) {
  double total = 0.0;
  for (int i = 0; i < n_sym; ++i) total += probs[i] > 0 ? probs[i] : 1e-12;
  freq.assign(n_sym, 1);
  uint32_t assigned = static_cast<uint32_t>(n_sym);
  std::vector<std::pair<double, int>> rema(n_sym);
  for (int i = 0; i < n_sym; ++i) {
    const double p = (probs[i] > 0 ? probs[i] : 1e-12) / total;
    const double ideal = p * PROB_SCALE;
    uint32_t f = ideal > 1.0 ? static_cast<uint32_t>(ideal) : 1u;
    assigned += f - freq[i];
    freq[i] = f;
    rema[i] = {ideal - f, i};
  }
  if (assigned < PROB_SCALE) {
    std::sort(rema.begin(), rema.end(),
              [](auto& a, auto& b) { return a.first > b.first; });
    uint32_t left = PROB_SCALE - assigned;
    for (uint32_t k = 0; left > 0; k = (k + 1) % n_sym, --left)
      freq[rema[k].second] += 1;
  } else if (assigned > PROB_SCALE) {
    std::sort(rema.begin(), rema.end(),
              [](auto& a, auto& b) { return a.first < b.first; });
    uint32_t over = assigned - PROB_SCALE;
    for (uint32_t k = 0; over > 0; k = (k + 1) % n_sym) {
      int i = rema[k].second;
      if (freq[i] > 1) { freq[i] -= 1; --over; }
    }
  }
  cum.assign(n_sym + 1, 0);
  for (int i = 0; i < n_sym; ++i) cum[i + 1] = cum[i] + freq[i];
}

}  // namespace

extern "C" long rans_categorical_encode(const int32_t* symbols, long n,
                                        const double* probs, int n_sym,
                                        uint32_t* out_buf, long out_cap) {
  std::vector<uint32_t> freq, cum;
  build_categorical(probs, n_sym, freq, cum);
  std::vector<uint32_t> words;
  words.reserve(static_cast<size_t>(n) / 2 + 4);
  uint64_t x = RANS_L;
  for (long i = n - 1; i >= 0; --i) {
    int32_t s = symbols[i];
    if (s < 0 || s >= n_sym) return -2;
    const uint32_t f = freq[s];
    const uint32_t c = cum[s];
    const uint64_t x_max = ((RANS_L >> PROB_BITS) << 32) * f;
    if (x >= x_max) {
      words.push_back(static_cast<uint32_t>(x));
      x >>= 32;
    }
    x = ((x / f) << PROB_BITS) + (x % f) + c;
  }
  const long total = static_cast<long>(words.size()) + 2;
  if (total > out_cap) return -1;
  out_buf[0] = static_cast<uint32_t>(x >> 32);
  out_buf[1] = static_cast<uint32_t>(x);
  for (size_t i = 0; i < words.size(); ++i)
    out_buf[2 + i] = words[words.size() - 1 - i];
  return total;
}

extern "C" long rans_categorical_decode(const uint32_t* buf, long nwords,
                                        long n, const double* probs,
                                        int n_sym, int32_t* out_symbols) {
  std::vector<uint32_t> freq, cum;
  build_categorical(probs, n_sym, freq, cum);
  if (nwords < 2) return -1;
  uint64_t x = (static_cast<uint64_t>(buf[0]) << 32) | buf[1];
  long pos = 2;
  for (long i = 0; i < n; ++i) {
    const uint32_t slot = static_cast<uint32_t>(x & (PROB_SCALE - 1));
    int lo = 0, hi = n_sym;
    while (hi - lo > 1) {
      const int mid = (lo + hi) / 2;
      if (cum[mid] <= slot) lo = mid; else hi = mid;
    }
    out_symbols[i] = lo;
    x = freq[lo] * (x >> PROB_BITS) + slot - cum[lo];
    if (x < RANS_L && pos < nwords) {
      x = (x << 32) | buf[pos++];
    }
  }
  return 0;
}

}  // extern "C"
