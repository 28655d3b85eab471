// tilawa-tpu native edit-distance core.
//
// The reference pipeline leans on python-Levenshtein's C implementation for
// its fuzzy retrieval hot loop (reference: shared/quran_db.py:6 — ~3x6,236
// ratio() calls per predict).  This is the TPU-framework's host-side
// equivalent: a small, dependency-free C++ library exposing
//
//   * lev_distance   — classic Levenshtein distance (sub cost 1)
//   * indel_distance — insert/delete-only distance (sub cost 2 semantics);
//                      ratio = (m+n-indel)/(m+n) matches python-Levenshtein's
//                      ratio() exactly (it equals 2*LCS/(m+n))
//   * semi_global_distance — query vs best substring of ref (free gaps in
//                      ref), the fragmentScore primitive
//   * batched corpus scans of all three against a concatenated corpus,
//     multithreaded — one call scores a query against all 6,236 verses.
//
// Strings cross the boundary as uint32 codepoint arrays (Python str ->
// array of ord()).  Two-row DP, O(min) space; ukkonen-style early-exit
// bounds are intentionally omitted: the batched scan wants every score.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

inline int dp_lev(const uint32_t* a, int m, const uint32_t* b, int n,
                  std::vector<int>& row) {
  if (m == 0) return n;
  if (n == 0) return m;
  if (m > n) { std::swap(a, b); std::swap(m, n); }
  row.resize(m + 1);
  for (int i = 0; i <= m; ++i) row[i] = i;
  for (int j = 1; j <= n; ++j) {
    int diag = row[0];
    row[0] = j;
    const uint32_t bj = b[j - 1];
    for (int i = 1; i <= m; ++i) {
      const int up = row[i];
      const int cost = (a[i - 1] == bj) ? 0 : 1;
      int v = diag + cost;
      if (up + 1 < v) v = up + 1;
      if (row[i - 1] + 1 < v) v = row[i - 1] + 1;
      diag = up;
      row[i] = v;
    }
  }
  return row[m];
}

// ---------------------------------------------------------------------------
// Bit-parallel LCS length (Crochemore-Iliopoulos-Pinzon-Reid / Hyyrö).
// Recurrence per text char c:  U = V & M[c];  V = (V + U) | (V & ~M[c])
// with multiword carry. LCS = number of zero bits among the low m bits of V.
// The low m bits evolve independently of any junk above them (carries only
// propagate upward), so V starts as all-ones with no end masking needed
// until the final popcount.
// ---------------------------------------------------------------------------

struct BitPattern {
  int m = 0;
  int words = 0;
  // mask rows: row 0 is the all-zero mask for chars absent from the pattern.
  std::vector<uint64_t> rows;
  std::unordered_map<uint32_t, int> index;
  // Direct-address fast path: Arabic text spans a ~1.6K codepoint range, so
  // a flat [lo, hi] table replaces the per-char hash lookup in the O(n*m)
  // inner loop (the windowed partial_ratio scan hits mask_for ~windows*len
  // times per corpus row).
  std::vector<int32_t> flat;
  uint32_t flat_lo = 0;
  bool use_flat = false;
  static constexpr uint32_t kMaxFlatRange = 8192;

  void build(const uint32_t* p, int m_) {
    m = m_;
    words = (m + 63) >> 6;
    rows.assign(static_cast<size_t>(words), 0);  // row 0: zeros
    index.clear();
    use_flat = false;
    uint32_t lo = ~0u, hi = 0;
    for (int i = 0; i < m; ++i) {
      const uint32_t c = p[i];
      if (c < lo) lo = c;
      if (c > hi) hi = c;
      auto it = index.find(c);
      int r;
      if (it == index.end()) {
        r = static_cast<int>(rows.size() / words);
        index.emplace(c, r);
        rows.resize(rows.size() + words, 0);
      } else {
        r = it->second;
      }
      rows[static_cast<size_t>(r) * words + (i >> 6)] |= 1ULL << (i & 63);
    }
    if (m > 0 && hi - lo < kMaxFlatRange) {
      flat.assign(hi - lo + 1, 0);
      for (const auto& kv : index) flat[kv.first - lo] = kv.second;
      flat_lo = lo;
      use_flat = true;
    }
  }

  const uint64_t* mask_for(uint32_t c) const {
    int r = 0;
    if (use_flat) {
      const uint32_t off = c - flat_lo;
      if (off < flat.size()) r = flat[off];
    } else {
      auto it = index.find(c);
      r = it == index.end() ? 0 : it->second;
    }
    return rows.data() + static_cast<size_t>(r) * words;
  }

  // LCS length between the pattern and text[0..n).
  int lcs(const uint32_t* text, int n, std::vector<uint64_t>& v) const {
    if (m == 0 || n == 0) return 0;
    v.assign(static_cast<size_t>(words), ~0ULL);
    for (int j = 0; j < n; ++j) {
      const uint64_t* mk = mask_for(text[j]);
      uint64_t carry = 0;
      for (int w = 0; w < words; ++w) {
        const uint64_t vw = v[w];
        const uint64_t u = vw & mk[w];
        const uint64_t s1 = vw + u;
        uint64_t c1 = s1 < vw;
        const uint64_t s2 = s1 + carry;
        c1 |= s2 < s1;
        v[w] = s2 | (vw & ~mk[w]);
        carry = c1;
      }
    }
    int zeros = 0;
    for (int w = 0; w < words; ++w) {
      uint64_t bits = ~v[w];
      if (w == words - 1 && (m & 63)) bits &= (1ULL << (m & 63)) - 1;
      zeros += __builtin_popcountll(bits);
    }
    return zeros;
  }
};

// Indel distance = m + n - 2*LCS(a, b); computed via the LCS DP.
// Kept as the scalar oracle for the bit-parallel path.
inline int dp_indel(const uint32_t* a, int m, const uint32_t* b, int n,
                    std::vector<int>& row) {
  if (m == 0) return n;
  if (n == 0) return m;
  if (m > n) { std::swap(a, b); std::swap(m, n); }
  row.assign(m + 1, 0);
  for (int j = 1; j <= n; ++j) {
    int diag = 0;
    const uint32_t bj = b[j - 1];
    for (int i = 1; i <= m; ++i) {
      const int up = row[i];
      int v;
      if (a[i - 1] == bj) {
        v = diag + 1;
      } else {
        v = (up > row[i - 1]) ? up : row[i - 1];
      }
      diag = up;
      row[i] = v;
    }
  }
  return m + n - 2 * row[m];
}

// Semi-global: align the whole query against any substring of ref.
inline int dp_semi_global(const uint32_t* q, int m, const uint32_t* r, int n,
                          std::vector<int>& row) {
  if (m == 0) return 0;
  if (n == 0) return m;
  row.resize(m + 1);
  for (int i = 0; i <= m; ++i) row[i] = i;
  int best = row[m];
  for (int j = 1; j <= n; ++j) {
    int diag = row[0];
    row[0] = 0;  // free to start anywhere in ref
    const uint32_t rj = r[j - 1];
    for (int i = 1; i <= m; ++i) {
      const int up = row[i];
      const int cost = (q[i - 1] == rj) ? 0 : 1;
      int v = diag + cost;
      if (up + 1 < v) v = up + 1;
      if (row[i - 1] + 1 < v) v = row[i - 1] + 1;
      diag = up;
      row[i] = v;
    }
    if (row[m] < best) best = row[m];  // free to end anywhere in ref
  }
  return best;
}

// Best indel ratio of the shorter string against every window of its own
// length in the longer string (reference: shared/quran_db.py:10-28).
// Pattern masks are built once for the short side; each window costs
// O(window_len * ceil(m/64)) via the bit-parallel LCS.
inline double bp_partial_ratio(const uint32_t* a, int m, const uint32_t* b,
                               int n, BitPattern& pat,
                               std::vector<uint64_t>& v) {
  if (m == 0 || n == 0) return 0.0;
  if (m > n) { std::swap(a, b); std::swap(m, n); }
  pat.build(a, m);
  const int windows = std::max(1, n - m + 1);

  auto window_ratio = [&](int s) -> double {
    const int lcs = pat.lcs(b + s, std::min(m, n - s), v);
    return static_cast<double>(lcs) / m;  // (2m - (2m-2*lcs)) / 2m
  };

  // Exact pruned search: LCS against adjacent windows differs by at most 1
  // per offset shift (Lipschitz in the offset), so a coarse pass with step
  // `st` bounds every skipped offset o in (s0, s1) by
  //   ratio(o) <= min(r0 + (o-s0)/m, r1 + (s1-o)/m),
  // whose max over the open interval is (r0+r1)/2 + (s1-s0)/(2m). Intervals
  // that can't beat the running best are skipped — identical result to the
  // dense scan at ~step-fold fewer LCS evaluations.
  const int step = std::max(1, m / 8);
  if (windows <= 4 || step == 1) {
    double best = 0.0;
    for (int s = 0; s < windows; ++s) {
      const double r = window_ratio(s);
      if (r > best) {
        best = r;
        if (best >= 1.0) break;
      }
    }
    return best;
  }

  std::vector<int> coarse_pos;
  std::vector<double> coarse_val;
  double best = 0.0;
  for (int s = 0; s < windows; s += step) {
    const double r = window_ratio(s);
    coarse_pos.push_back(s);
    coarse_val.push_back(r);
    if (r > best) {
      best = r;
      if (best >= 1.0) return best;
    }
  }
  if (coarse_pos.back() != windows - 1) {
    const double r = window_ratio(windows - 1);
    coarse_pos.push_back(windows - 1);
    coarse_val.push_back(r);
    if (r > best) best = r;
    if (best >= 1.0) return best;
  }
  const double inv_m = 1.0 / m;
  for (size_t k = 0; k + 1 < coarse_pos.size(); ++k) {
    const int s0 = coarse_pos[k], s1 = coarse_pos[k + 1];
    if (s1 - s0 <= 1) continue;
    const double bound =
        0.5 * (coarse_val[k] + coarse_val[k + 1]) + 0.5 * (s1 - s0) * inv_m;
    if (bound <= best + 1e-12) continue;
    for (int s = s0 + 1; s < s1; ++s) {
      const double r = window_ratio(s);
      if (r > best) {
        best = r;
        if (best >= 1.0) return best;
      }
    }
  }
  return best;
}

enum Kind { KIND_LEV = 0, KIND_INDEL = 1, KIND_SEMI = 2, KIND_PARTIAL = 3 };

void scan_range(int kind, const uint32_t* q, int qlen, const uint32_t* corpus,
                const int64_t* offsets, const int64_t* indices, int lo, int hi,
                double* out) {
  std::vector<int> row;
  std::vector<uint64_t> v;
  BitPattern qpat;       // query-side masks, built lazily once
  BitPattern spat;       // per-row masks for partial when the row is shorter
  bool qpat_built = false;
  for (int k = lo; k < hi; ++k) {
    const int64_t idx = indices ? indices[k] : k;
    const uint32_t* s = corpus + offsets[idx];
    const int slen = static_cast<int>(offsets[idx + 1] - offsets[idx]);
    switch (kind) {
      case KIND_LEV:
        out[k] = dp_lev(q, qlen, s, slen, row);
        break;
      case KIND_INDEL: {
        const int lensum = qlen + slen;
        if (!lensum) { out[k] = 1.0; break; }
        if (qlen == 0 || slen == 0) { out[k] = 0.0; break; }
        if (!qpat_built) { qpat.build(q, qlen); qpat_built = true; }
        const int lcs = qpat.lcs(s, slen, v);
        out[k] = static_cast<double>(2 * lcs) / lensum;
        break;
      }
      case KIND_SEMI: {
        const int d = dp_semi_global(q, qlen, s, slen, row);
        out[k] = qlen ? std::max(0.0, 1.0 - static_cast<double>(d) / qlen) : 1.0;
        break;
      }
      case KIND_PARTIAL: {
        if (qlen == 0 || slen == 0) { out[k] = 0.0; break; }
        if (qlen <= slen) {
          if (!qpat_built) { qpat.build(q, qlen); qpat_built = true; }
          const int windows = std::max(1, slen - qlen + 1);
          double best = 0.0;
          for (int w = 0; w < windows; ++w) {
            const int lcs = qpat.lcs(s + w, qlen, v);
            const double r = static_cast<double>(lcs) / qlen;
            if (r > best) { best = r; if (best >= 1.0) break; }
          }
          out[k] = best;
        } else {
          out[k] = bp_partial_ratio(s, slen, q, qlen, spat, v);
        }
        break;
      }
    }
  }
}

}  // namespace

extern "C" {

int lev_distance(const uint32_t* a, int m, const uint32_t* b, int n) {
  std::vector<int> row;
  return dp_lev(a, m, b, n, row);
}

int indel_distance(const uint32_t* a, int m, const uint32_t* b, int n) {
  if (m == 0 || n == 0) return m + n;
  BitPattern pat;
  std::vector<uint64_t> v;
  pat.build(a, m);
  return m + n - 2 * pat.lcs(b, n, v);
}

// Scalar-DP variant kept callable for cross-validation of the bit-parallel
// path from the Python test suite.
int indel_distance_scalar(const uint32_t* a, int m, const uint32_t* b, int n) {
  std::vector<int> row;
  return dp_indel(a, m, b, n, row);
}

int semi_global_distance(const uint32_t* q, int m, const uint32_t* r, int n) {
  std::vector<int> row;
  return dp_semi_global(q, m, r, n, row);
}

double lev_ratio(const uint32_t* a, int m, const uint32_t* b, int n) {
  const int lensum = m + n;
  if (lensum == 0) return 1.0;
  return static_cast<double>(lensum - indel_distance(a, m, b, n)) / lensum;
}

double partial_ratio(const uint32_t* a, int m, const uint32_t* b, int n) {
  BitPattern pat;
  std::vector<uint64_t> v;
  return bp_partial_ratio(a, m, b, n, pat, v);
}

// Batched scan: `kind` selects the metric (0=lev distance, 1=indel ratio,
// 2=fragment score, 3=partial ratio).  `corpus` is all strings concatenated;
// `offsets` has num_strings+1 entries.  When `indices` is non-null, only the
// `count` rows it names are scored (results land in out[0..count)); when
// null, all `count` corpus rows are scored in order.
static void batch_scan_impl(int kind, const uint32_t* q, int qlen,
                            const uint32_t* corpus, const int64_t* offsets,
                            const int64_t* indices, int count, int num_threads,
                            double* out) {
  if (count <= 0) return;
  if (num_threads <= 1 || count < 64) {
    scan_range(kind, q, qlen, corpus, offsets, indices, 0, count, out);
    return;
  }
  const int hw = static_cast<int>(std::thread::hardware_concurrency());
  int nt = std::min(num_threads, hw > 0 ? hw : 4);
  nt = std::min(nt, count);
  std::vector<std::thread> threads;
  threads.reserve(nt);
  const int per = (count + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    const int lo = t * per;
    const int hi = std::min(count, lo + per);
    if (lo >= hi) break;
    threads.emplace_back(scan_range, kind, q, qlen, corpus, offsets, indices,
                         lo, hi, out);
  }
  for (auto& th : threads) th.join();
}

void batch_scan(int kind, const uint32_t* q, int qlen, const uint32_t* corpus,
                const int64_t* offsets, int num_strings, int num_threads,
                double* out) {
  batch_scan_impl(kind, q, qlen, corpus, offsets, nullptr, num_strings,
                  num_threads, out);
}

void batch_scan_subset(int kind, const uint32_t* q, int qlen,
                       const uint32_t* corpus, const int64_t* offsets,
                       const int64_t* indices, int count, int num_threads,
                       double* out) {
  batch_scan_impl(kind, q, qlen, corpus, offsets, indices, count, num_threads,
                  out);
}

}  // extern "C"
