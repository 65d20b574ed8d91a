// Native data-loading tier: high-throughput time-series parsers.
//
// The reference streams observation files through Akka's JVM IO stages
// (Data.scala:252-272, Framing.delimiter + per-line parsing).  This is the
// equivalent native runtime component of composablestatespacemodels_torch,
// the same source as composablestatespacemodels_tpu/native/fastio.cpp: a
// single-pass C++ parser (one read(2) burst, zero per-line allocation)
// exposed through a C ABI and bound with ctypes, feeding the host side of
// the filter pipeline without Python string overhead.  It runs on the host
// only; the series it parses is then placed on the device.
//
// Formats:
//   CSV  : "t,y\n" with empty or "NA" observation meaning missing
//   JSON : line-delimited {"t": <num>, "observation": <num>|null}
//
// Build (native/loader.py, at first use):
//   g++ -O3 -shared -fPIC fastio.cpp -o _build/fastio-<hash>/libcssm_fastio.so

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cctype>

extern "C" {

struct TsData {
  double* ts;
  double* ys;
  unsigned char* mask;
  long n;
  long capacity;
};

static TsData* tsdata_new() {
  TsData* d = (TsData*)std::malloc(sizeof(TsData));
  d->capacity = 1024;
  d->n = 0;
  d->ts = (double*)std::malloc(sizeof(double) * d->capacity);
  d->ys = (double*)std::malloc(sizeof(double) * d->capacity);
  d->mask = (unsigned char*)std::malloc(d->capacity);
  return d;
}

static void tsdata_push(TsData* d, double t, double y, unsigned char m) {
  if (d->n == d->capacity) {
    d->capacity *= 2;
    d->ts = (double*)std::realloc(d->ts, sizeof(double) * d->capacity);
    d->ys = (double*)std::realloc(d->ys, sizeof(double) * d->capacity);
    d->mask = (unsigned char*)std::realloc(d->mask, d->capacity);
  }
  d->ts[d->n] = t;
  d->ys[d->n] = y;
  d->mask[d->n] = m;
  d->n++;
}

void cssm_free_tsdata(TsData* d) {
  if (!d) return;
  std::free(d->ts);
  std::free(d->ys);
  std::free(d->mask);
  std::free(d);
}

static char* read_whole_file(const char* path, long* size_out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  char* buf = (char*)std::malloc(size + 1);
  long got = (long)std::fread(buf, 1, size, f);
  std::fclose(f);
  buf[got] = '\0';
  *size_out = got;
  return buf;
}

// CSV: t,y per line; y empty or "NA" => missing
TsData* cssm_parse_timeseries_csv(const char* path) {
  long size = 0;
  char* buf = read_whole_file(path, &size);
  if (!buf) return nullptr;
  TsData* d = tsdata_new();

  char* p = buf;
  char* end = buf + size;
  while (p < end) {
    // skip blank lines, whitespace-only ones included: strtod would skip
    // their newline and read the next line's time as this line's
    while (p < end && std::isspace((unsigned char)*p)) p++;
    if (p >= end) break;
    char* eol = (char*)std::memchr(p, '\n', end - p);
    if (!eol) eol = end;

    char* after;
    double t = std::strtod(p, &after);
    if (after == p) { p = eol + 1; continue; }  // unparseable: skip line
    // find comma
    char* c = after;
    while (c < eol && *c != ',') c++;
    double y = 0.0;
    unsigned char m = 0;
    if (c < eol) {
      char* v = c + 1;
      while (v < eol && std::isspace((unsigned char)*v)) v++;
      if (v < eol && !(v + 1 < eol && v[0] == 'N' && v[1] == 'A')
          && *v != '\r') {
        char* ya;
        double yv = std::strtod(v, &ya);
        if (ya != v) { y = yv; m = 1; }
      }
    }
    tsdata_push(d, t, y, m);
    p = eol + 1;
  }
  std::free(buf);
  return d;
}

// line-delimited JSON: {"t": <num>, "observation": <num>|null}
TsData* cssm_parse_timeseries_json(const char* path) {
  long size = 0;
  char* buf = read_whole_file(path, &size);
  if (!buf) return nullptr;
  TsData* d = tsdata_new();

  char* p = buf;
  char* end = buf + size;
  while (p < end) {
    char* eol = (char*)std::memchr(p, '\n', end - p);
    if (!eol) eol = end;

    char* tk = (char*)std::strstr(p, "\"t\"");
    if (tk && tk < eol) {
      char* colon = (char*)std::memchr(tk, ':', eol - tk);
      if (colon) {
        char* after;
        double t = std::strtod(colon + 1, &after);
        if (after != colon + 1) {
          double y = 0.0;
          unsigned char m = 0;
          char* ok = (char*)std::strstr(p, "\"observation\"");
          if (ok && ok < eol) {
            char* c2 = (char*)std::memchr(ok, ':', eol - ok);
            if (c2) {
              char* v = c2 + 1;
              while (v < eol && std::isspace((unsigned char)*v)) v++;
              if (v < eol && std::strncmp(v, "null", 4) != 0) {
                char* ya;
                double yv = std::strtod(v, &ya);
                if (ya != v) { y = yv; m = 1; }
              }
            }
          }
          tsdata_push(d, t, y, m);
        }
      }
    }
    p = eol + 1;
  }
  std::free(buf);
  return d;
}

long cssm_tsdata_n(TsData* d) { return d->n; }
double* cssm_tsdata_ts(TsData* d) { return d->ts; }
double* cssm_tsdata_ys(TsData* d) { return d->ys; }
unsigned char* cssm_tsdata_mask(TsData* d) { return d->mask; }

// writer: CSV rows with empty field for missing
int cssm_write_timeseries_csv(const char* path, const double* ts,
                              const double* ys, const unsigned char* mask,
                              long n) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  char line[128];
  for (long i = 0; i < n; i++) {
    int len;
    if (mask[i]) {
      len = std::snprintf(line, sizeof(line), "%.17g,%.17g\n", ts[i], ys[i]);
    } else {
      len = std::snprintf(line, sizeof(line), "%.17g,\n", ts[i]);
    }
    std::fwrite(line, 1, len, f);
  }
  std::fclose(f);
  return 0;
}

// writer: dense float matrix as CSV with a caller-supplied header line --
// the posterior-to-CSV hot path (the reference JsonToCSV app,
// DetermineParameters.scala:90-101, writes 100k-iteration chains)
int cssm_write_matrix_csv(const char* path, const char* header,
                          const double* vals, long rows, long cols) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  int ok = 1;
  if (header && header[0]) {
    ok &= std::fputs(header, f) >= 0;
    ok &= std::fputc('\n', f) != EOF;
  }
  char cell[64];
  for (long i = 0; ok && i < rows; i++) {
    const double* r = vals + i * cols;
    for (long j = 0; j < cols; j++) {
      int len = std::snprintf(cell, sizeof(cell), "%.17g", r[j]);
      ok &= std::fwrite(cell, 1, len, f) == (size_t)len;
      ok &= std::fputc(j + 1 < cols ? ',' : '\n', f) != EOF;
    }
  }
  // a short write (ENOSPC, I/O error) must fail loudly so the Python
  // caller falls back / raises instead of keeping a truncated chain
  ok &= !std::ferror(f);
  ok &= std::fclose(f) == 0;
  return ok ? 0 : -1;
}

}  // extern "C"
