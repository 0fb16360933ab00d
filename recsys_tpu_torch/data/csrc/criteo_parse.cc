// Criteo CSV/TSV parsing for the port's file-fed training path: a label,
// 13 dense values and 26 categorical tokens a row, each token hashed with
// FNV-1a 64 into a fixed number of buckets.  The row rules are those of
// the JAX package's native/recsys_native.cc, kept byte for byte so both
// packages hash the same files to the same ids:
//
//   * an empty label or dense field reads as 0; an empty categorical field
//     hashes the empty token;
//   * a line of at least 14 fields counts as a row; fields past the 40th
//     are ignored; a categorical column a short row never wrote keeps what
//     the output buffer held at that row;
//   * a line of fewer than 14 fields is skipped (its label and dense values
//     are written to the next row's slot and then overwritten);
//   * the header line is skipped only at byte offset 0.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 (recsys_tpu_torch/data/native.py
// does it at first use).

#include <cstdint>
#include <cstdio>
#include <cstdlib>

extern "C" {

static inline uint64_t fnv1a64(const char* s, size_t n) {
  uint64_t h = 1469598103934665603ULL;
  for (size_t i = 0; i < n; ++i) {
    h ^= (uint64_t)(unsigned char)s[i];
    h *= 1099511628211ULL;
  }
  return h;
}

// One line's fields into row `row` of the outputs; returns the number of
// fields seen (at most 40).
static int parse_line(char* line, ssize_t len, char sep, int64_t row,
                      int64_t cat_buckets, float* labels, float* dense,
                      int32_t* sparse) {
  char* p = line;
  char* end = line + len;
  while (end > p && (end[-1] == '\n' || end[-1] == '\r')) --end;
  int field = 0;
  char* tok = p;
  for (char* q = p; q <= end && field < 40; ++q) {
    if (q == end || *q == sep) {
      size_t tl = (size_t)(q - tok);
      if (field == 0) {
        labels[row] = tl ? (float)atof(tok) : 0.f;
      } else if (field <= 13) {
        dense[row * 13 + (field - 1)] = tl ? (float)atof(tok) : 0.f;
      } else {
        uint64_t h = fnv1a64(tok, tl);
        sparse[row * 26 + (field - 14)] = (int32_t)(h % (uint64_t)cat_buckets);
      }
      ++field;
      tok = q + 1;
    }
  }
  return field;
}

// Parse up to max_rows rows of a whole file.  Returns the rows parsed, -1
// when the file cannot be opened.
int64_t parse_criteo(const char* path, char sep, int64_t max_rows,
                     int64_t cat_buckets, int skip_header, float* labels,
                     float* dense /* (rows, 13) */,
                     int32_t* sparse /* (rows, 26) */) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  char* line = nullptr;
  size_t cap = 0;
  int64_t row = 0;
  if (skip_header && getline(&line, &cap, f) < 0) {
    free(line);
    fclose(f);
    return 0;
  }
  while (row < max_rows) {
    ssize_t len = getline(&line, &cap, f);
    if (len < 0) break;
    if (parse_line(line, len, sep, row, cat_buckets, labels, dense, sparse) >= 14) ++row;
  }
  free(line);
  fclose(f);
  return row;
}

// Parse up to max_rows rows from byte start_offset (the header is skipped
// only at offset 0) and write the offset to resume from, so a file larger
// than memory streams through a fixed buffer.  Returns the rows parsed (0
// at the end of the file), -1 when the file cannot be opened or sought.
int64_t parse_criteo_chunk(const char* path, char sep, int64_t start_offset,
                           int64_t max_rows, int64_t cat_buckets,
                           int skip_header, float* labels,
                           float* dense /* (rows, 13) */,
                           int32_t* sparse /* (rows, 26) */,
                           int64_t* next_offset) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  if (start_offset > 0 && fseek(f, (long)start_offset, SEEK_SET) != 0) {
    fclose(f);
    return -1;
  }
  char* line = nullptr;
  size_t cap = 0;
  int64_t row = 0;
  if (skip_header && start_offset == 0 && getline(&line, &cap, f) < 0) {
    *next_offset = ftell(f);
    free(line);
    fclose(f);
    return 0;
  }
  while (row < max_rows) {
    ssize_t len = getline(&line, &cap, f);
    if (len < 0) break;
    if (parse_line(line, len, sep, row, cat_buckets, labels, dense, sparse) >= 14) ++row;
  }
  *next_offset = ftell(f);
  free(line);
  fclose(f);
  return row;
}

}  // extern "C"
