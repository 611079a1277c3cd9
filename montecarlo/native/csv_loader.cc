// Fast OHLCV CSV loader — the framework's native data-ingestion path.
//
// The reference's data layer is yfinance -> pandas on the Python host
// (reference app.py:887-896). For local/batch data this loader replaces the
// pandas CSV path: mmap the file, one pass, branch-light float parsing.
// Exposed through ctypes (montecarlo/data/_native.py) with a pure-Python
// fallback, so the toolchain is optional.
//
// Contract: CSV with a header row; columns named (case-insensitively)
// open/high/low/close/volume are extracted in file order into five
// newly-malloc'd double arrays. Rows with unparsable fields become NaN.
// Returns the number of data rows, or -1 on error.

#include <cctype>
#include <cerrno>
#include <cmath>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Column {
  const char* name;
  int index;  // column position in the file, -1 if absent
};

// Case-insensitive match of a header cell against a target name.
bool cell_is(const char* begin, const char* end, const char* target) {
  const char* p = begin;
  // Strip quotes and whitespace.
  while (p < end && (*p == '"' || std::isspace(*p))) ++p;
  const char* q = end;
  while (q > p && (q[-1] == '"' || std::isspace(q[-1]) || q[-1] == '\r')) --q;
  size_t n = std::strlen(target);
  if (static_cast<size_t>(q - p) != n) return false;
  for (size_t i = 0; i < n; ++i) {
    if (std::tolower(p[i]) != target[i]) return false;
  }
  return true;
}

const char* next_line(const char* p, const char* end) {
  while (p < end && *p != '\n') ++p;
  return p < end ? p + 1 : end;
}

}  // namespace

extern "C" {

// Parse OHLCV columns out of a CSV file.
//   path        — file path
//   out[5]      — receives malloc'd arrays: open, high, low, close, volume
// Returns row count, or -1 (errno-style failure: missing file / header /
// required column).
long mctpu_load_ohlcv(const char* path, double** out_open, double** out_high,
                      double** out_low, double** out_close,
                      double** out_volume) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return -1;
  struct stat st;
  if (::fstat(fd, &st) != 0 || st.st_size == 0) {
    ::close(fd);
    return -1;
  }
  size_t size = static_cast<size_t>(st.st_size);
  const char* data = static_cast<const char*>(
      ::mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0));
  ::close(fd);
  if (data == MAP_FAILED) return -1;
  const char* end = data + size;

  // --- header: locate the five columns -------------------------------------
  Column cols[5] = {{"open", -1}, {"high", -1}, {"low", -1},
                    {"close", -1}, {"volume", -1}};
  {
    const char* p = data;
    const char* line_end = p;
    while (line_end < end && *line_end != '\n') ++line_end;
    int idx = 0;
    bool in_quotes = false;
    const char* cell = p;
    for (const char* q = p; q <= line_end; ++q) {
      if (q < line_end && *q == '"') in_quotes = !in_quotes;
      if (q == line_end || (*q == ',' && !in_quotes)) {
        for (auto& c : cols) {
          if (c.index < 0 && cell_is(cell, q, c.name)) c.index = idx;
        }
        cell = q + 1;
        ++idx;
      }
    }
    for (const auto& c : cols) {
      if (c.index < 0) {
        ::munmap(const_cast<char*>(data), size);
        return -1;
      }
    }
  }

  // --- count data rows ------------------------------------------------------
  long n_rows = 0;
  for (const char* p = next_line(data, end); p < end;
       p = next_line(p, end)) {
    // Skip blank trailing lines.
    if (*p != '\n' && *p != '\r') ++n_rows;
  }

  double* arrays[5];
  for (int i = 0; i < 5; ++i) {
    arrays[i] = static_cast<double*>(std::malloc(sizeof(double) * n_rows));
    if (!arrays[i]) {
      for (int j = 0; j < i; ++j) std::free(arrays[j]);
      ::munmap(const_cast<char*>(data), size);
      return -1;
    }
  }

  // --- parse ---------------------------------------------------------------
  int max_col = 0;
  for (const auto& c : cols) max_col = c.index > max_col ? c.index : max_col;

  long row = 0;
  for (const char* p = next_line(data, end); p < end && row < n_rows;
       p = next_line(p, end)) {
    if (*p == '\n' || *p == '\r') continue;
    const char* line_end = p;
    while (line_end < end && *line_end != '\n') ++line_end;

    double values[5];
    for (auto& v : values) v = std::nan("");
    int idx = 0;
    bool in_quotes = false;  // commas inside quoted cells are not separators
    const char* cell = p;
    for (const char* q = p; q <= line_end && idx <= max_col; ++q) {
      if (q < line_end && *q == '"') in_quotes = !in_quotes;
      if (q == line_end || (*q == ',' && !in_quotes)) {
        for (int c = 0; c < 5; ++c) {
          if (cols[c].index == idx) {
            // Copy into a NUL-terminated stack buffer: strtod on the raw
            // mmap would scan for a terminator past the mapping when the
            // file's last field ends exactly at a page boundary (SIGSEGV).
            char buf[64];
            const char* b = cell;
            while (b < q && (*b == '"' || std::isspace(*b))) ++b;
            const char* e = q;
            while (e > b && (e[-1] == '"' || std::isspace(e[-1])
                             || e[-1] == '\r')) --e;
            size_t len = static_cast<size_t>(e - b);
            if (len >= sizeof buf) len = sizeof buf - 1;
            std::memcpy(buf, b, len);
            buf[len] = '\0';
            char* parse_end = nullptr;
            errno = 0;
            double v = std::strtod(buf, &parse_end);
            values[c] = (parse_end == buf || errno == ERANGE)
                            ? std::nan("")
                            : v;
          }
        }
        cell = q + 1;
        ++idx;
      }
    }
    arrays[0][row] = values[0];
    arrays[1][row] = values[1];
    arrays[2][row] = values[2];
    arrays[3][row] = values[3];
    arrays[4][row] = values[4];
    ++row;
  }

  ::munmap(const_cast<char*>(data), size);
  *out_open = arrays[0];
  *out_high = arrays[1];
  *out_low = arrays[2];
  *out_close = arrays[3];
  *out_volume = arrays[4];
  return row;
}

void mctpu_free(double* ptr) { std::free(ptr); }

}  // extern "C"
