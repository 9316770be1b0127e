// Native host components of fastsmc_tpu_torch (a copy of
// fastsmc_tpu/native/fastsmc_native.cpp).
//
// The GPU owns the validation compute; these are the host-side hot paths
// that the reference implements in C++ and that are dict-heavy or RNG-exact:
//
//   * undistinguished-allele hypergeometric sampling with the platform's
//     real std::rand / std::mt19937 / std::shuffle (bit-identical to the
//     reference Data.cpp:144-160, 567-599 by construction);
//   * the GERMLINE2 word-hashing identification scan
//     (reference FastSMC.cpp:118-235 + HASHING/*), with insertion-ordered
//     seed buckets and match table so the emission order matches the
//     Python oracle implementation (hashing/germline.py) exactly;
//   * the IBD record and posterior-sums text formatters of io/writers.py.
//
// Exposed as a small C ABI consumed via ctypes (no pybind11 dependency).

#include <algorithm>
#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <random>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// undistinguished counts (Data.cpp:144-160, 567-599)
// ---------------------------------------------------------------------------

static int sample_hypergeometric(int population_size, int number_of_successes,
                                 int sample_size) {
  if (number_of_successes < 0 || number_of_successes > population_size) {
    return -1;
  }
  std::vector<unsigned short> v(population_size, 0);
  for (int i = 0; i < number_of_successes; i++) v[i] = 1;
  std::shuffle(v.begin(), v.end(), std::mt19937(std::rand()));
  int ret = 0;
  for (int i = 0; i < sample_size; i++) ret += v[i];
  return ret;
}

// out: int32 [sites * 3]; returns 0 on success
int fastsmc_undistinguished(long sites, const int* derived_counts,
                            const int* total_counts, int csfs_samples,
                            int fold, unsigned seed, int* out) {
  std::srand(seed);
  for (long i = 0; i < sites; i++) {
    const int derived = derived_counts[i];
    const int total = total_counts[i];
    for (int distinguished = 0; distinguished < 3; distinguished++) {
      int s = sample_hypergeometric(total - 2, derived - distinguished,
                                    csfs_samples - 2);
      if (fold && (s + distinguished > csfs_samples / 2)) {
        s = csfs_samples - 2 - s;
      }
      out[i * 3 + distinguished] = s;
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// GERMLINE2 hashing scan
// ---------------------------------------------------------------------------

namespace {

struct Match {
  int64_t loc;
  int w0;
  int w1;
  bool dead;
};

struct ScanState {
  // parameters
  const uint64_t* words;    // [n_haps, n_words]
  int n_haps;
  int n_words;
  const int64_t* id_num;    // [n_haps]
  bool haploid;
  bool has_windows;
  int jobs, job_ind;
  uint64_t w_i, w_j, window_size;
  bool is_j_above_diag;
  double min_m;
  const float* gpos;        // [n_positions] Morgans
  int64_t n_positions;
  int word_size;
  int read_ahead;
  int gap;
  int max_seeds;
  double skip;

  // extend hash: insertion-ordered vector + location index
  std::vector<Match> matches;
  std::unordered_map<int64_t, size_t> match_index;
  size_t compact_from = 0;

  // output: either fixed caller buffers (single-shot fastsmc_hash_scan)
  // or internal accumulation vectors (chunked scan handle API)
  int32_t* out_id1 = nullptr;
  int32_t* out_id2 = nullptr;
  int64_t* out_from = nullptr;
  int64_t* out_to = nullptr;
  int64_t capacity = 0;
  int64_t n_out = 0;
  bool overflow = false;
  bool accumulate = false;
  std::vector<int32_t> acc_id1, acc_id2;
  std::vector<int64_t> acc_from, acc_to;

  // reused per-word bucket storage (chunked scans keep allocations warm)
  std::unordered_map<uint64_t, size_t> bucket_idx;
  std::vector<std::vector<int>> buckets;

  uint64_t num;  // hashing units

  int64_t pair_to_location(int i, int j) const {
    if (!haploid) {
      i = (i - (i % 2)) / 2;
      j = (j - (j % 2)) / 2;
    }
    return (i > j) ? (int64_t)j * (int64_t)num + i
                   : (int64_t)i * (int64_t)num + j;
  }

  void location_to_pair(int64_t loc, int* first, int* second) const {
    if (haploid) {
      *second = (int)(loc % (int64_t)num);
      *first = (int)((loc - *second) / (int64_t)num);
    } else {
      int64_t s = loc % (int64_t)num;
      *second = (int)(2 * s);
      *first = (int)(2 * ((loc - s) / (int64_t)num));
    }
  }

  bool pair_in_window(int ind_i, int ind_j) const {
    if (!has_windows) return true;
    const uint64_t id_i = (uint64_t)id_num[ind_i];
    const uint64_t id_j = (uint64_t)id_num[ind_j];
    const uint64_t ws = window_size;
    if (job_ind == jobs) {
      if (id_i >= (w_i - 1) * ws && id_j >= (w_j - 1) * ws) {
        return id_j < (w_j - 1) * ws + (id_i - (w_i - 1) * ws);
      }
      return false;
    }
    if (id_i >= (w_i - 1) * ws && id_i < w_i * ws &&
        id_j >= (w_j - 1) * ws && id_j < w_j * ws) {
      if (is_j_above_diag) {
        return id_j < (w_j - 1) * ws + (id_i - (w_i - 1) * ws);
      }
      return id_j >= (w_j - 1) * ws + (id_i - (w_i - 1) * ws);
    }
    return false;
  }

  void extend_pair(int i, int j, int w, int current_word) {
    const int64_t loc = pair_to_location(i, j);
    auto it = match_index.find(loc);
    if (it == match_index.end()) {
      match_index.emplace(loc, matches.size());
      matches.push_back(Match{loc, current_word, w > 0 ? w : 0, false});
    } else {
      Match& m = matches[it->second];
      if (w > m.w1) m.w1 = w;
    }
  }

  double cm_between(int w1, int w2) const {
    const int64_t start = (int64_t)word_size * w1;
    int64_t end = (int64_t)word_size * w2 + word_size - 1;
    if (end > n_positions - 1) end = n_positions - 1;
    return 100.0 * ((double)gpos[end] - (double)gpos[start]);
  }

  void print_match(const Match& m) {
    const double mlen = cm_between(m.w0, m.w1);
    if (mlen >= min_m) {
      int p1, p2;
      location_to_pair(m.loc, &p1, &p2);
      if (accumulate) {
        acc_id1.push_back(p1);
        acc_id2.push_back(p2);
        acc_from.push_back((int64_t)m.w0 * word_size);
        acc_to.push_back((int64_t)m.w1 * word_size + word_size - 1);
        return;
      }
      if (n_out >= capacity) {
        overflow = true;
        return;
      }
      out_id1[n_out] = p1;
      out_id2[n_out] = p2;
      out_from[n_out] = (int64_t)m.w0 * word_size;
      out_to[n_out] = (int64_t)m.w1 * word_size + word_size - 1;
      n_out++;
    }
  }

  void clear_pairs_prior_to(int w) {
    size_t dst = 0;
    for (size_t i = 0; i < matches.size(); i++) {
      Match& m = matches[i];
      if (m.w1 < w) {
        print_match(m);
        match_index.erase(m.loc);
      } else {
        if (dst != i) {
          matches[dst] = m;
          match_index[m.loc] = dst;
        }
        dst++;
      }
    }
    matches.resize(dst);
  }

  void extend_all_pairs_to(int w) {
    for (auto& m : matches) m.w1 = w;
  }

  void clear_all_pairs() {
    for (auto& m : matches) print_match(m);
    matches.clear();
    match_index.clear();
  }

  // insertion-ordered bucketization of hap indices by word value
  long extend_all_pairs(const std::vector<std::vector<int>>& buckets, int w,
                        int read_words, int current_word) {
    long tot = 0;
    for (const auto& members : buckets) {
      if (max_seeds != 0 && (int)members.size() > max_seeds &&
          w + 1 < read_words) {
        // recursive sub-hash on the next word (SeedHash.hpp:56-93)
        std::unordered_map<uint64_t, size_t> idx;
        std::vector<std::vector<int>> sub;
        for (int i : members) {
          const uint64_t h = words[(size_t)i * n_words + (w + 1)];
          auto it = idx.find(h);
          if (it == idx.end()) {
            idx.emplace(h, sub.size());
            sub.emplace_back();
            sub.back().push_back(i);
          } else {
            sub[it->second].push_back(i);
          }
        }
        tot += extend_all_pairs(sub, w + 1, read_words, current_word);
        continue;
      }
      const size_t n = members.size();
      for (size_t a = 0; a < n; a++) {
        for (size_t b = a + 1; b < n; b++) {
          const int ind_i = std::max(members[a], members[b]);
          const int ind_j = std::min(members[a], members[b]);
          if (pair_in_window(ind_i, ind_j)) {
            extend_pair(ind_j, ind_i, w, current_word);
            tot++;
          }
        }
      }
    }
    return tot;
  }

  // scan the word range [w_begin, w_end); carries the extend-hash state
  // across calls so a chunked scan emits the exact same stream (same
  // matches, same order) as one full pass
  void scan_range(int w_begin, int w_end) {
    for (int w = w_begin; w < w_end; w++) {
      const int read_words = std::min(n_words, w + read_ahead);
      bucket_idx.clear();
      buckets.clear();
      for (int i = 0; i < n_haps; i++) {
        const uint64_t h = words[(size_t)i * n_words + w];
        auto it = bucket_idx.find(h);
        if (it == bucket_idx.end()) {
          bucket_idx.emplace(h, buckets.size());
          buckets.emplace_back();
          buckets.back().push_back(i);
        } else {
          buckets[it->second].push_back(i);
        }
      }
      const double cur_seeds = (double)buckets.size();
      if (cur_seeds / (double)n_haps > skip) {
        extend_all_pairs(buckets, w, read_words, w);
        clear_pairs_prior_to(w - gap);
      } else {
        extend_all_pairs_to(w);
      }
      if (!accumulate && overflow) return;
    }
  }
};

}  // namespace

static ScanState* make_scan_state(
    const uint64_t* words, int n_haps, int n_words, const int64_t* id_num,
    int haploid, int has_windows, int jobs, int job_ind, uint64_t w_i,
    uint64_t w_j, uint64_t window_size, int is_j_above_diag, double min_m,
    const float* genetic_positions, long n_positions, int word_size,
    int read_ahead, int gap, int max_seeds, double skip) {
  ScanState* st = new ScanState();
  st->words = words;
  st->n_haps = n_haps;
  st->n_words = n_words;
  st->id_num = id_num;
  st->haploid = haploid != 0;
  st->has_windows = has_windows != 0;
  st->jobs = jobs;
  st->job_ind = job_ind;
  st->w_i = w_i;
  st->w_j = w_j;
  st->window_size = window_size;
  st->is_j_above_diag = is_j_above_diag != 0;
  st->min_m = min_m;
  st->gpos = genetic_positions;
  st->n_positions = n_positions;
  st->word_size = word_size;
  st->read_ahead = read_ahead;
  st->gap = gap;
  st->max_seeds = max_seeds;
  st->skip = skip;
  st->num = (uint64_t)n_haps;
  return st;
}

// Returns the number of matches written, or -1 on output-capacity overflow.
long fastsmc_hash_scan(
    const uint64_t* words, int n_haps, int n_words, const int64_t* id_num,
    int haploid, int has_windows, int jobs, int job_ind, uint64_t w_i,
    uint64_t w_j, uint64_t window_size, int is_j_above_diag, double min_m,
    const float* genetic_positions, long n_positions, int word_size,
    int read_ahead, int gap, int max_seeds, double skip, int32_t* out_id1,
    int32_t* out_id2, int64_t* out_from, int64_t* out_to, long capacity) {
  ScanState* st = make_scan_state(
      words, n_haps, n_words, id_num, haploid, has_windows, jobs, job_ind,
      w_i, w_j, window_size, is_j_above_diag, min_m, genetic_positions,
      n_positions, word_size, read_ahead, gap, max_seeds, skip);
  st->out_id1 = out_id1;
  st->out_id2 = out_id2;
  st->out_from = out_from;
  st->out_to = out_to;
  st->capacity = capacity;
  st->scan_range(0, n_words);
  if (!st->overflow) st->clear_all_pairs();
  const long n = st->overflow ? -1 : (long)st->n_out;
  delete st;
  return n;
}

// ---------------------------------------------------------------------------
// chunked scan handle API: scan word ranges incrementally so the Python
// side can overlap identification with validation (the producer thread
// stays inside these GIL-releasing ctypes calls while the main thread
// batches/decodes the previous chunk's candidates). Only one thread may
// touch a handle at a time; matches accumulate internally and are copied
// out with fastsmc_scan_take.
// ---------------------------------------------------------------------------

void* fastsmc_scan_create(
    const uint64_t* words, int n_haps, int n_words, const int64_t* id_num,
    int haploid, int has_windows, int jobs, int job_ind, uint64_t w_i,
    uint64_t w_j, uint64_t window_size, int is_j_above_diag, double min_m,
    const float* genetic_positions, long n_positions, int word_size,
    int read_ahead, int gap, int max_seeds, double skip) {
  ScanState* st = make_scan_state(
      words, n_haps, n_words, id_num, haploid, has_windows, jobs, job_ind,
      w_i, w_j, window_size, is_j_above_diag, min_m, genetic_positions,
      n_positions, word_size, read_ahead, gap, max_seeds, skip);
  st->accumulate = true;
  return st;
}

long fastsmc_scan_words(void* handle, int w_begin, int w_end) {
  ScanState* st = (ScanState*)handle;
  st->scan_range(w_begin, w_end);
  return (long)st->acc_id1.size();
}

long fastsmc_scan_finish(void* handle) {
  ScanState* st = (ScanState*)handle;
  st->clear_all_pairs();
  return (long)st->acc_id1.size();
}

// copy accumulated matches out and clear the accumulator; returns n, or
// -1 if capacity < n (retry with bigger buffers — state is untouched)
long fastsmc_scan_take(void* handle, int32_t* out_id1, int32_t* out_id2,
                       int64_t* out_from, int64_t* out_to, long capacity) {
  ScanState* st = (ScanState*)handle;
  const long n = (long)st->acc_id1.size();
  if (n > capacity) return -1;
  std::memcpy(out_id1, st->acc_id1.data(), n * sizeof(int32_t));
  std::memcpy(out_id2, st->acc_id2.data(), n * sizeof(int32_t));
  std::memcpy(out_from, st->acc_from.data(), n * sizeof(int64_t));
  std::memcpy(out_to, st->acc_to.data(), n * sizeof(int64_t));
  st->acc_id1.clear();
  st->acc_id2.clear();
  st->acc_from.clear();
  st->acc_to.clear();
  return n;
}

void fastsmc_scan_destroy(void* handle) { delete (ScanState*)handle; }

// ---------------------------------------------------------------------------
// bulk IBD text-record formatting (HMM.cpp:1114-1144 line layout)
//
// A biobank chromosome emits ~1e5-1e6 records; the per-record Python
// formatting path costs ~10 us each (two "%.7g" and a join), dominating
// the output phase. This formats a whole drained flush group in one call.
// id_blob holds "<famid>\t<iid>\0" per individual, id_off its start
// offsets; %.7g here is the same C printf the Python "%.7g" uses, so the
// bytes are identical to the Python path.
// ---------------------------------------------------------------------------

// returns bytes written, or -1 if out_cap would overflow.
// post_est / map_est (nullable, float32) append the reference default
// profile's age columns (HMM.cpp:1179-1357, 13-column records).
long fastsmc_format_ibd(long n, const char* id_blob, const int* id_off,
                        const int* ind1, const int* hap1, const int* ind2,
                        const int* hap2, const int64_t* pos_start,
                        const int64_t* pos_end, const float* length_cm,
                        int has_len, const double* score,
                        const float* post_est, int has_post,
                        const float* map_est, int has_map,
                        const char* chr_str, char* out, long out_cap) {
  long w = 0;
  for (long i = 0; i < n; i++) {
    if (out_cap - w < 320) return -1;
    const char* id1 = id_blob + id_off[ind1[i]];
    const char* id2 = id_blob + id_off[ind2[i]];
    w += std::snprintf(out + w, out_cap - w,
                       "%s\t%d\t%s\t%d\t%s\t%lld\t%lld", id1, hap1[i], id2,
                       hap2[i], chr_str,
                       (long long)pos_start[i], (long long)pos_end[i]);
    if (has_len && w < out_cap) {
      w += std::snprintf(out + w, out_cap - w, "\t%.7g",
                         (double)length_cm[i]);
    }
    if (w < out_cap) {
      w += std::snprintf(out + w, out_cap - w, "\t%.7g", score[i]);
    }
    if (has_post && w < out_cap) {
      w += std::snprintf(out + w, out_cap - w, "\t%.7g",
                         (double)post_est[i]);
    }
    if (has_map && w < out_cap) {
      w += std::snprintf(out + w, out_cap - w, "\t%.7g",
                         (double)map_est[i]);
    }
    if (w < out_cap) {
      w += std::snprintf(out + w, out_cap - w, "\n");
    }
    // snprintf returns the would-be length: w > out_cap means this
    // record truncated (e.g. ids longer than the 320-byte headroom) —
    // report failure so the caller falls back to the Python formatter
    if (w >= out_cap) return -1;
  }
  return w;
}

// ---------------------------------------------------------------------------
// posterior-sums text (main.cpp:119-167: Eigen's default format of a float
// matrix, values as the stream's default-float at precision 6, "\t"
// between them, "\n" after every row)
//
// Python's "%.6g" of each value, the text the writers' fallback makes:
// std::to_chars' general format at precision 6 is printf's "%.6g" in the
// C locale; the non-finite values take Python's spellings ("nan" for
// either sign, where printf writes "-nan"; "inf", "-inf").
// ---------------------------------------------------------------------------

static int format_g6(double v, char* out) {
  if (std::isnan(v)) {
    std::memcpy(out, "nan", 3);
    return 3;
  }
  if (std::isinf(v)) {
    int n = v < 0 ? 4 : 3;
    std::memcpy(out, v < 0 ? "-inf" : "inf", n);
    return n;
  }
#if defined(__cpp_lib_to_chars) && __cpp_lib_to_chars >= 201611L
  return (int)(std::to_chars(out, out + 32, v, std::chars_format::general, 6)
                   .ptr - out);
#else
  return std::snprintf(out, 32, "%.6g", v);
#endif
}

// rows x cols row-major values; returns bytes written, or -1 if out_cap
// is too small for them.
long fastsmc_format_sums(const double* mat, long rows, long cols, char* out,
                         long out_cap) {
  long w = 0;
  char tmp[32];
  for (long r = 0; r < rows; r++) {
    const double* row = mat + r * cols;
    for (long c = 0; c < cols; c++) {
      int n = format_g6(row[c], tmp);
      if (out_cap - w < n + 1) return -1;
      std::memcpy(out + w, tmp, n);
      w += n;
      out[w++] = c + 1 < cols ? '\t' : '\n';
    }
    if (cols == 0) {
      if (out_cap - w < 1) return -1;
      out[w++] = '\n';
    }
  }
  return w;
}

}  // extern "C"
