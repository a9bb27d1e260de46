// Interval algebra of pb_chime5_tpu_torch.utils.array_interval.
//
// The JAX package's cpp/interval_ops.cpp with a plain C interface in place
// of the CPython module table (ops/kernels/_build.py compiles it with the
// host compiler at first use; utils/array_interval.py loads it with
// ctypes).  An interval list is an int64 (n, 2) buffer of (start, stop)
// pairs, half-open; the caller sizes each output and every entry returns
// the number of pairs it wrote:
//
//   pb_intersection(start, stop, ivs, n, out)       out: <= n pairs
//   pb_non_intersection(start, stop, ivs, n, out)   out: <= 2n pairs
//   pb_normalize(ivs, n, out)                       out: <= n pairs
//   pb_str_to_intervals(text, out, capacity, err, err_len)
//       '1:4, 5:20' -> (1, 4), (5, 20); capacity: the commas + 1.  Returns
//       -1 with "bad interval token in <text>" in `err`.  Each number is
//       read by std::stoll, which takes the longest prefix that is one:
//       '1:4x' and '1:4:5' give (1, 4), as the JAX package's native parser
//       gives them (its Python parser raises on both).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <exception>
#include <string>
#include <utility>
#include <vector>

namespace {

using Interval = std::pair<int64_t, int64_t>;

int64_t emit(int64_t* out, int64_t k, int64_t s, int64_t e) {
  out[2 * k] = s;
  out[2 * k + 1] = e;
  return k + 1;
}

}  // namespace

extern "C" int64_t pb_intersection(int64_t start, int64_t stop,
                                   const int64_t* ivs, int64_t n,
                                   int64_t* out) {
  int64_t k = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t s = std::max(start, ivs[2 * i]);
    int64_t e = std::min(stop, ivs[2 * i + 1]);
    if (s < e) k = emit(out, k, s, e);
  }
  return k;
}

// Half-open set subtraction: remove [start, stop) from every interval.
extern "C" int64_t pb_non_intersection(int64_t start, int64_t stop,
                                       const int64_t* ivs, int64_t n,
                                       int64_t* out) {
  int64_t k = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t s = ivs[2 * i], e = ivs[2 * i + 1];
    if (e <= start || s >= stop) {  // disjoint
      k = emit(out, k, s, e);
      continue;
    }
    if (s < start) k = emit(out, k, s, start);  // left remainder
    if (e > stop) k = emit(out, k, stop, e);    // right remainder
  }
  return k;
}

// Sort, drop empties, merge touching or overlapping intervals.
extern "C" int64_t pb_normalize(const int64_t* ivs, int64_t n, int64_t* out) {
  std::vector<Interval> valid;
  valid.reserve(static_cast<size_t>(n));
  for (int64_t i = 0; i < n; ++i)
    if (ivs[2 * i] < ivs[2 * i + 1]) valid.emplace_back(ivs[2 * i], ivs[2 * i + 1]);
  std::sort(valid.begin(), valid.end());
  int64_t k = 0;
  for (const auto& [s, e] : valid) {
    if (k > 0 && s <= out[2 * k - 1]) {
      out[2 * k - 1] = std::max(out[2 * k - 1], e);
    } else {
      k = emit(out, k, s, e);
    }
  }
  return k;
}

extern "C" int64_t pb_str_to_intervals(const char* text, int64_t* out,
                                       int64_t capacity, char* err,
                                       int64_t err_len) {
  std::string s;
  for (const char* p = text; *p; ++p)
    if (*p != ' ') s.push_back(*p);
  // strip trailing commas
  while (!s.empty() && s.back() == ',') s.pop_back();
  int64_t k = 0;
  size_t pos = 0;
  while (pos < s.size()) {
    size_t comma = s.find(',', pos);
    if (comma == std::string::npos) comma = s.size();
    size_t colon = s.find(':', pos);
    bool ok = colon != std::string::npos && colon < comma && k < capacity;
    if (ok) {
      try {
        int64_t a = std::stoll(s.substr(pos, colon - pos));
        int64_t b = std::stoll(s.substr(colon + 1, comma - colon - 1));
        k = emit(out, k, a, b);
      } catch (const std::exception&) {
        ok = false;
      }
    }
    if (!ok) {
      if (err_len > 0)
        snprintf(err, static_cast<size_t>(err_len),
                 "bad interval token in %s", text);
      return -1;
    }
    pos = comma + 1;
  }
  return k;
}
