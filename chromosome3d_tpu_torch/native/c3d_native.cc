// Native host-side hot paths for chromosome3d_tpu.
//
// The reference's host layer is Perl text munging (chromosome3D.pl:110-206):
// at L=456 the whitespace float matrix is ~2 MB of text parsed cell by cell.
// This library provides a single-pass parser plus a PDB ATOM-row emitter,
// exposed through a minimal C ABI consumed via ctypes
// (chromosome3d_tpu/native/__init__.py). Python remains the fallback when the
// library isn't built.
//
// Validation contract: the parser accepts EXACTLY what the Python loader
// (io/matrix.py) accepts — an L x L grid of numeric tokens with every row the
// same width — and declines (returns -1) anything else, so a malformed file
// falls through to the Python path and raises the same descriptive error with
// or without the .so built. The file is read into a NUL-terminated heap
// buffer (never strtod'd off the end of an mmap page).
//
// Build: make -C chromosome3d_tpu/native

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>

namespace {

// Read the whole file into a NUL-terminated string; empty on failure.
std::string read_file(const char* path) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return {};
  fseek(fp, 0, SEEK_END);
  long size = ftell(fp);
  if (size <= 0) {
    fclose(fp);
    return {};
  }
  std::string buf(static_cast<size_t>(size), '\0');
  fseek(fp, 0, SEEK_SET);
  size_t got = fread(&buf[0], 1, buf.size(), fp);
  fclose(fp);
  if (got != buf.size()) return {};
  return buf;  // c_str() provides the trailing NUL strtod may touch
}

inline bool is_blank(char c) { return c == ' ' || c == '\t' || c == '\r' ||
                                      c == '\v' || c == '\f'; }

// Parse a well-formed whitespace matrix. Writes row-major values into out
// (may be null to validate/count only). Returns the square side L, or -1 if
// the file is empty, ragged, non-square, or contains a non-numeric token.
int64_t parse_matrix_checked(const std::string& text, double* out, int64_t cap) {
  const char* p = text.c_str();
  const char* end = p + text.size();
  int64_t n = 0;        // values written
  int64_t rows = 0;
  int64_t width = -1;   // tokens in the first non-empty row
  while (p < end) {
    // one line
    const char* eol = static_cast<const char*>(memchr(p, '\n', end - p));
    const char* line_end = eol ? eol : end;
    int64_t row_tokens = 0;
    while (p < line_end) {
      while (p < line_end && is_blank(*p)) ++p;
      if (p >= line_end) break;
      char* next = nullptr;
      double v = strtod(p, &next);
      if (next == p || next > line_end) return -1;  // non-numeric token
      // the token must end at whitespace/EOL (reject e.g. "1.5x")
      if (next < line_end && !is_blank(*next)) return -1;
      if (out) {
        if (n >= cap) return -1;
        out[n] = v;
      }
      ++n;
      ++row_tokens;
      p = next;
    }
    if (row_tokens > 0) {
      if (width < 0) width = row_tokens;
      if (row_tokens != width) return -1;  // ragged row
      ++rows;
    }
    p = eol ? eol + 1 : end;
  }
  if (rows == 0 || rows != width) return -1;  // empty or non-square
  return rows;
}

}  // namespace

extern "C" {

// Side length L of a well-formed L x L matrix file, or -1 (malformed files
// decline to the Python loader, which raises the descriptive error).
int64_t c3d_matrix_dims(const char* path) {
  std::string text = read_file(path);
  if (text.empty()) return -1;
  return parse_matrix_checked(text, nullptr, 0);
}

// Fill out[0..L*L) row-major; returns L or -1. cap guards the buffer.
int64_t c3d_parse_matrix(const char* path, double* out, int64_t cap) {
  std::string text = read_file(path);
  if (text.empty()) return -1;
  return parse_matrix_checked(text, out, cap);
}

// Emit a CA-bead PDB byte-identical to io/pdb.py write_ca_pdb: optional
// pre-formatted header lines (REMARK rows, passed through verbatim — must
// already end each line with '\n'), ATOM rows, optional CONECT chain, END.
// Returns 0 on success (byte-parity-tested against the Python writer).
// The _v2 suffix versions the ABI: round 3 changed the signature (3 -> 6
// args), and ctypes cannot detect a signature change under the same symbol
// name — a stale .so would be called "successfully" with the extra args
// ignored and silently emit old-format PDBs. A missing _v2 symbol instead
// raises AttributeError at load, and the loader falls back to Python.
int32_t c3d_write_ca_pdb_v2(const char* path, const double* xyz, int64_t L,
                            const char* header, const char* resname,
                            int32_t connect) {
  FILE* fp = fopen(path, "w");
  if (!fp) return -1;
  if (header && header[0]) fputs(header, fp);
  for (int64_t i = 0; i < L; ++i) {
    fprintf(fp,
            "ATOM  %5lld  CA  %-3s  %4lld    %8.3f%8.3f%8.3f  1.00  0.00    "
            "       C  \n",
            static_cast<long long>(i + 1), resname ? resname : "MET",
            static_cast<long long>(i + 1), xyz[3 * i], xyz[3 * i + 1],
            xyz[3 * i + 2]);
  }
  if (connect) {
    for (int64_t i = 1; i < L; ++i) {
      fprintf(fp, "CONECT%5lld%5lld\n", static_cast<long long>(i),
              static_cast<long long>(i + 1));
    }
  }
  fputs("END\n", fp);
  if (fclose(fp) != 0) return -1;
  return 0;
}

// ---------------------------------------------------------------------------
// Text-artifact emitters (round 3): at L=3000 the Python per-cell f-string
// loops spent minutes writing .dist/.rr/contact.tbl. Formatting semantics
// are byte-identical to the Python writers (parity-tested): glibc printf
// and CPython both produce correctly-rounded fixed-precision decimals.
// ---------------------------------------------------------------------------

// `$ID.dist`: L x L of "%.1f " cells, one row per line. Returns 0.
int32_t c3d_write_dist(const char* path, const double* v, int64_t L) {
  FILE* fp = fopen(path, "w");
  if (!fp) return -1;
  setvbuf(fp, nullptr, _IOFBF, 1 << 20);
  for (int64_t i = 0; i < L; ++i) {
    for (int64_t j = 0; j < L; ++j) {
      fprintf(fp, "%.1f ", v[i * L + j]);
    }
    fputc('\n', fp);
  }
  if (fclose(fp) != 0) return -1;
  return 0;
}

// `$ID.rr` rows "i j %.2f %.2f 1.0" for PRE-ORDERED (i, j, d) arrays (the
// caller computes the reference's string-key sort order). Returns 0.
int32_t c3d_write_rr_rows(const char* path, const int32_t* ii,
                          const int32_t* jj, const double* dd, int64_t n) {
  FILE* fp = fopen(path, "w");
  if (!fp) return -1;
  setvbuf(fp, nullptr, _IOFBF, 1 << 20);
  for (int64_t k = 0; k < n; ++k) {
    fprintf(fp, "%d %d %.2f %.2f 1.0\n", ii[k], jj[k], dd[k], dd[k]);
  }
  if (fclose(fp) != 0) return -1;
  return 0;
}

// carr2tbl (chromosome3D.pl:340-362): rr rows -> CNS NOE tbl rows, incl.
// the literal `lo == "0"` STRING special case. Returns the row count, or -1
// on I/O failure OR any digit-leading row the Python writer would reject
// (< 4 tokens, non-integer i/j, non-numeric lo/hi) — declining hands the
// file to the Python fallback so malformed input raises the same loud
// error with or without the .so built (the library's parity contract).

static bool all_digits(const char* t) {
  if (!*t) return false;
  for (; *t; ++t)
    if (*t < '0' || *t > '9') return false;
  return true;
}
int64_t c3d_rr_to_tbl(const char* rr_path, const char* tbl_path,
                      double zero_d, double zero_neg) {
  FILE* probe = fopen(rr_path, "rb");
  if (!probe) return -1;
  fclose(probe);
  std::string text = read_file(rr_path);  // empty = zero restraints, legal
  FILE* out = fopen(tbl_path, "w");
  if (!out) return -1;
  setvbuf(out, nullptr, _IOFBF, 1 << 20);
  int64_t n = 0;
  const char* p = text.c_str();
  const char* end = p + text.size();
  while (p < end) {
    const char* eol = static_cast<const char*>(memchr(p, '\n', end - p));
    const char* line_end = eol ? eol : end;
    // skip leading whitespace; keep lines starting with a digit (the same
    // `line[0].isdigit()` acceptance as the Python writer)
    const char* q = p;
    while (q < line_end && (*q == ' ' || *q == '\t' || *q == '\r')) ++q;
    if (q < line_end && *q >= '0' && *q <= '9') {
      char tok[4][64];
      int nt = 0;
      const char* r = q;
      while (r < line_end && nt < 4) {
        while (r < line_end && (*r == ' ' || *r == '\t' || *r == '\r')) ++r;
        if (r >= line_end) break;
        int len = 0;
        while (r < line_end && !(*r == ' ' || *r == '\t' || *r == '\r') &&
               len < 63) {
          tok[nt][len++] = *r++;
        }
        if (len == 63 && r < line_end &&
            !(*r == ' ' || *r == '\t' || *r == '\r')) {
          // token overflows the buffer: decline to the Python writer rather
          // than silently splitting it into two parsed values
          fclose(out);
          return -1;
        }
        tok[nt][len] = '\0';
        ++nt;
      }
      if (nt < 4) {
        fclose(out);
        return -1;                    // Python raises IndexError here
      }
      {
        if (!all_digits(tok[0]) || !all_digits(tok[1])) {
          fclose(out);
          return -1;                  // Python's int() would raise
        }
        char* e2 = nullptr;
        char* e3 = nullptr;
        double lo = strtod(tok[2], &e2);
        double hi = strtod(tok[3], &e3);
        if (e2 == tok[2] || *e2 != '\0' || e3 == tok[3] || *e3 != '\0') {
          fclose(out);
          return -1;                  // Python's float() would raise
        }
        double distance = (hi + lo) / 2.0;
        double negdev = (hi - lo) / 2.0;
        double posdev = negdev;
        if (strcmp(tok[2], "0") == 0) {
          distance = zero_d;
          negdev = zero_neg;
          posdev = hi - zero_d;
        }
        fprintf(out,
                "assign45 (resid %3d and name ca) (resid %3d and name ca) "
                "%.2f %.2f %.2f\n",
                atoi(tok[0]), atoi(tok[1]), distance, negdev, posdev);
        ++n;
      }
    }
    p = eol ? eol + 1 : end;
  }
  if (fclose(out) != 0) return -1;
  return n;
}

}  // extern "C"
