// Native host-side data pipeline for insider_tpu.
//
// The reference is an in-RAM R workflow: read.table + log2(x+1) in R
// (tests/ageing.R:33-36) and an R-level element splitter (R/utils.R:78-117).
// At the target scales (500k x 1M, BASELINE.json) host-side parsing and mask
// generation become real bottlenecks, so this library provides:
//
//   * numeric CSV/TSV parsing: mmap + OpenMP chunk-parallel parse into a
//     caller-provided float32 buffer (one pass to index newlines, one
//     parallel pass to parse),
//   * log2(x+1) transform (OpenMP SIMD),
//   * seeded masked train/test element splitting with NaN exclusion —
//     the ratio_splitter semantics (test set = floor(ratio * observed),
//     sampled without replacement), implemented with per-row splitmix64
//     counters so mask generation is embarrassingly parallel and
//     deterministic given (seed, shape).
//
// Exposed with a plain C ABI for ctypes (no pybind11 in this image).

#include <algorithm>
#include <atomic>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#endif

extern "C" {

// ---------------------------------------------------------------- parsing --

struct ParsedShape {
  int64_t rows;
  int64_t cols;
};

// Pass 1: count data rows and columns. Returns 0 on success.
int insider_csv_shape(const char* path, char delim, int skip_header,
                      int64_t* rows, int64_t* cols) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  struct stat st;
  if (fstat(fd, &st) != 0) { close(fd); return -2; }
  size_t n = (size_t)st.st_size;
  const char* buf =
      (const char*)mmap(nullptr, n, PROT_READ, MAP_PRIVATE, fd, 0);
  close(fd);
  if (buf == MAP_FAILED) return -3;

  int64_t r = 0, c = 0;
  size_t i = 0;
  // first (possibly header) line: count columns
  size_t line_end = i;
  while (line_end < n && buf[line_end] != '\n') line_end++;
  c = 1;
  for (size_t j = i; j < line_end; j++)
    if (buf[j] == delim) c++;
  // count lines: newline count, +1 if the file lacks a trailing newline
  int64_t nl = 0;
  for (size_t j = 0; j < n; j++)
    if (buf[j] == '\n') nl++;
  int64_t lines = nl + ((n > 0 && buf[n - 1] != '\n') ? 1 : 0);
  r = lines - (skip_header ? 1 : 0);
  munmap((void*)buf, n);
  *rows = r;
  *cols = c;
  return 0;
}

// Strict NA-token test: the field (already whitespace/quote-trimmed) is
// exactly "NA", "NaN", or "N/A", case-insensitive (R read.table's default
// na.strings plus the two universal spellings).  A previous version treated
// ANY field starting with 'N'/'n' as NaN, silently swallowing typos like
// "N5" or "null" — those now count as bad fields.
static inline bool is_na_token(const char* s, size_t len) {
  auto low = [](char ch) { return (char)std::tolower((unsigned char)ch); };
  if (len == 2 && low(s[0]) == 'n' && low(s[1]) == 'a') return true;
  if (len == 3 && low(s[0]) == 'n' && low(s[1]) == 'a' && low(s[2]) == 'n')
    return true;
  if (len == 3 && low(s[0]) == 'n' && s[1] == '/' && low(s[2]) == 'a')
    return true;
  return false;
}

// Pass 2: parse into out (row-major rows x cols float32). NaN for empty or
// NA-token fields; double-quoted fields are unwrapped (quoted delimiters are
// respected; embedded newlines are not supported — numeric matrices have
// none).  Any other unparsable field parses as NaN AND increments
// *bad_fields, so the caller can fail loudly instead of silently training on
// corrupted data.  Returns number of rows parsed, or <0 on error.
int64_t insider_csv_parse(const char* path, char delim, int skip_header,
                          int64_t rows, int64_t cols, float* out,
                          int64_t* bad_fields) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  struct stat st;
  if (fstat(fd, &st) != 0) { close(fd); return -2; }
  size_t n = (size_t)st.st_size;
  const char* buf =
      (const char*)mmap(nullptr, n, PROT_READ, MAP_PRIVATE, fd, 0);
  close(fd);
  if (buf == MAP_FAILED) return -3;

  // index line starts
  std::vector<size_t> starts;
  starts.reserve((size_t)rows + 2);
  starts.push_back(0);
  for (size_t j = 0; j + 1 < n; j++)
    if (buf[j] == '\n') starts.push_back(j + 1);
  size_t first = skip_header ? 1 : 0;
  int64_t avail = (int64_t)starts.size() - (int64_t)first;
  int64_t todo = avail < rows ? avail : rows;

  std::atomic<int64_t> ok{0};
  std::atomic<int64_t> bad{0};
#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
  for (int64_t r = 0; r < todo; r++) {
    size_t p = starts[first + (size_t)r];
    float* row = out + r * cols;
    int64_t bad_local = 0;
    for (int64_t c = 0; c < cols; c++) {
      // token boundaries: [tok, tok_end), quotes unwrapped, spaces trimmed
      while (p < n && (buf[p] == ' ' || (buf[p] == '\t' && delim != '\t')))
        p++;
      size_t tok, tok_end;
      bool quoted = (p < n && buf[p] == '"');
      if (quoted) {
        tok = ++p;
        while (p < n && buf[p] != '"' && buf[p] != '\n') p++;
        tok_end = p;
        if (p < n && buf[p] == '"') p++;  // closing quote
      } else {
        tok = p;
        while (p < n && buf[p] != delim && buf[p] != '\n') p++;
        tok_end = p;
        while (tok_end > tok &&
               (buf[tok_end - 1] == ' ' || buf[tok_end - 1] == '\r' ||
                (buf[tok_end - 1] == '\t' && delim != '\t')))
          tok_end--;
      }
      size_t len = tok_end - tok;
      if (len == 0) {
        row[c] = NAN;  // empty field == NA (R read.table)
      } else if (is_na_token(buf + tok, len)) {
        row[c] = NAN;
      } else {
        char* end = nullptr;
        row[c] = strtof(buf + tok, &end);
        // the whole token must be consumed — trailing junk is corruption
        if (end != buf + tok_end) {
          row[c] = NAN;
          bad_local++;
        }
      }
      // advance past the delimiter (skipping anything after a close quote)
      while (p < n && buf[p] != delim && buf[p] != '\n') p++;
      if (p < n && buf[p] == delim) p++;
    }
    if (bad_local) bad.fetch_add(bad_local, std::memory_order_relaxed);
    ok.fetch_add(1, std::memory_order_relaxed);
  }
  munmap((void*)buf, n);
  if (bad_fields) *bad_fields = bad.load();
  return ok.load();
}

// -------------------------------------------------------------- transform --

void insider_log2p1(float* data, int64_t n) {
  const float inv_ln2 = 1.4426950408889634f;
#if defined(_OPENMP)
#pragma omp parallel for simd schedule(static)
#endif
  for (int64_t i = 0; i < n; i++) {
    float v = data[i];
    data[i] = logf((v > 0.0f ? v : 0.0f) + 1.0f) * inv_ln2;
  }
}

// ---------------------------------------------------- block IO (sharding) --

// Read a rectangular block [r0, r1) x [c0, c1) of a row-major float32
// matrix stored raw on disk (n_cols_global columns per row) into `out`
// (row-major, (r1-r0) x (c1-c0)).  pread per row, OpenMP over rows — the
// per-shard-callback reader for build_problem_distributed: no process ever
// maps more than its own block (SURVEY.md §5 long-context row; the
// reference is a single in-RAM process, src/Makevars:11-13).
// Returns 0 on success, -1 on open failure, -2 on short read.
int insider_block_read_f32(const char* path, int64_t n_cols_global,
                           int64_t r0, int64_t r1, int64_t c0, int64_t c1,
                           float* out) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  const int64_t bw = c1 - c0;
  std::atomic<int> bad{0};
#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
  for (int64_t r = r0; r < r1; r++) {
    off_t off = (off_t)((r * n_cols_global + c0) * (int64_t)sizeof(float));
    ssize_t want = (ssize_t)(bw * (int64_t)sizeof(float));
    char* dst = (char*)(out + (r - r0) * bw);
    ssize_t got = 0;
    while (got < want) {
      ssize_t n = pread(fd, dst + got, (size_t)(want - got), off + got);
      if (n <= 0) {
        bad.store(1);
        break;
      }
      got += n;
    }
  }
  close(fd);
  return bad.load() ? -2 : 0;
}

// -------------------------------------------------------------- splitting --

static inline uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97f4A7C15ULL;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
  return x ^ (x >> 31);
}

// Masked element split (ratio_splitter semantics, R/utils.R:78-117):
// train/test/na are uint8 masks; test gets ~floor(ratio * n_observed)
// elements sampled without replacement among non-NaN entries.
//
// Parallel reservoir-free design: draw a uniform u64 per observed element
// keyed by (seed, linear index), then threshold at the k-th smallest draw —
// found with a two-pass histogram select — so the sample is exactly k
// elements, deterministic, and order-independent.
int64_t insider_split_mask(const float* data, int64_t n_elems, double ratio,
                           uint64_t seed, uint8_t* train, uint8_t* test,
                           uint8_t* na) {
  // pass 0: mark NaNs, count observed
  int64_t observed = 0;
#if defined(_OPENMP)
#pragma omp parallel for schedule(static) reduction(+ : observed)
#endif
  for (int64_t i = 0; i < n_elems; i++) {
    bool is_na = std::isnan(data[i]);
    na[i] = is_na ? 1 : 0;
    test[i] = 0;
    train[i] = is_na ? 0 : 1;
    observed += is_na ? 0 : 1;
  }
  int64_t k = (int64_t)(observed * ratio);
  if (k <= 0) return 0;

  // pass 1: histogram of top 16 bits of per-element hashes
  const int BUCKETS = 1 << 16;
  std::vector<int64_t> hist(BUCKETS, 0);
#if defined(_OPENMP)
#pragma omp parallel
  {
    std::vector<int64_t> local(BUCKETS, 0);
#pragma omp for schedule(static)
    for (int64_t i = 0; i < n_elems; i++) {
      if (!na[i]) local[splitmix64(seed ^ (uint64_t)i) >> 48]++;
    }
#pragma omp critical
    for (int b = 0; b < BUCKETS; b++) hist[b] += local[b];
  }
#else
  for (int64_t i = 0; i < n_elems; i++)
    if (!na[i]) hist[splitmix64(seed ^ (uint64_t)i) >> 48]++;
#endif

  // find threshold bucket
  int64_t acc = 0;
  int tb = 0;
  for (; tb < BUCKETS; tb++) {
    if (acc + hist[tb] >= k) break;
    acc += hist[tb];
  }
  int64_t need_in_bucket = k - acc;

  // pass 2: collect hashes within the threshold bucket to find exact cut
  std::vector<uint64_t> in_bucket;
  for (int64_t i = 0; i < n_elems; i++) {
    if (na[i]) continue;
    uint64_t h = splitmix64(seed ^ (uint64_t)i);
    if ((int)(h >> 48) == tb) in_bucket.push_back(h);
  }
  uint64_t cut;
  {
    std::vector<uint64_t>& v = in_bucket;
    int64_t idx = need_in_bucket - 1;
    if (idx < 0) idx = 0;
    if (idx >= (int64_t)v.size()) idx = (int64_t)v.size() - 1;
    std::nth_element(v.begin(), v.begin() + idx, v.end());
    cut = v[(size_t)idx];
  }

  // pass 3: mark test = hash below bucket, or in bucket and <= cut
  std::atomic<int64_t> picked{0};
#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
  for (int64_t i = 0; i < n_elems; i++) {
    if (na[i]) continue;
    uint64_t h = splitmix64(seed ^ (uint64_t)i);
    int b = (int)(h >> 48);
    if (b < tb || (b == tb && h <= cut)) {
      test[i] = 1;
      train[i] = 0;
      picked.fetch_add(1, std::memory_order_relaxed);
    }
  }
  return picked.load();
}

// Block-local masked split for DISTRIBUTED ingestion: generate the
// train/test/na masks of the [r0, r1) x [c0, c1) block of a conceptual
// n_rows x n_cols_global matrix, deterministically in (seed, global linear
// index) — every process computes ITS block independently and the blocks
// tile into one consistent global split, with no process ever holding the
// full mask.
//
// Sampling rule: element-wise Bernoulli(ratio) on the splitmix64 stream
// (test iff hash < ratio * 2^64).  This deviates from the full-matrix
// splitter's exact-k sample (insider_split_mask's histogram select needs
// the global hash order): at the >=1e9-element scales where distributed
// ingestion matters, |test|/observed concentrates around `ratio` to
// ~1/sqrt(n) — the documented trade for full block-parallel determinism.
// `data` may be NULL (no-NaN synthetic configs) or the block's values for
// NaN exclusion.  Returns the number of test elements in the block.
int64_t insider_split_mask_block(const float* data, int64_t n_cols_global,
                                 int64_t r0, int64_t r1, int64_t c0,
                                 int64_t c1, double ratio, uint64_t seed,
                                 uint8_t* train, uint8_t* test,
                                 uint8_t* na) {
  const int64_t bw = c1 - c0;
  const uint64_t cut =
      (ratio >= 1.0) ? UINT64_MAX : (uint64_t)(ratio * 18446744073709551616.0);
  std::atomic<int64_t> picked{0};
#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
  for (int64_t r = r0; r < r1; r++) {
    int64_t local = 0;
    for (int64_t c = c0; c < c1; c++) {
      int64_t gi = r * n_cols_global + c;
      int64_t li = (r - r0) * bw + (c - c0);
      bool is_na = data != nullptr && std::isnan(data[li]);
      na[li] = is_na ? 1 : 0;
      if (is_na) {
        train[li] = 0;
        test[li] = 0;
        continue;
      }
      bool is_test = splitmix64(seed ^ (uint64_t)gi) < cut;
      test[li] = is_test ? 1 : 0;
      train[li] = is_test ? 0 : 1;
      local += is_test ? 1 : 0;
    }
    picked.fetch_add(local, std::memory_order_relaxed);
  }
  return picked.load();
}

}  // extern "C"
