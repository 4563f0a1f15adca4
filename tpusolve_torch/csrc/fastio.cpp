// fastio: native text parsers for tpusolve_torch's readers (formats/ij.py,
// formats/mmio.py).
//
// The parse loops are tpusolve/native/fastio.cpp's three functions
// (fastio_parse_triplets, fastio_parse_pairs, fastio_parse_floats), so both
// packages read a file into the same arrays.  The entry points here take
// the file's bytes instead of its path: the caller reads the file (or a
// text stream) and passes a buffer that must hold a NUL byte at
// data[size], so that strtod can never run past the end.  A Python bytes
// object is such a buffer.
//
// Lines are skipped when blank, when they start with '%' or '#', and when
// they do not parse; a line's trailing fields are ignored.  Each function
// returns the number of entries parsed (at most max_entries).
//
// Build: g++ -O3 -shared -fPIC fastio.cpp -o libfastio.so
// (tpusolve_torch/kernels/build.py, at first use).

#include <cstdint>
#include <cstdlib>

namespace {

// skip spaces/tabs
inline const char* skip_ws(const char* p, const char* end) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
    return p;
}

inline const char* skip_line(const char* p, const char* end) {
    while (p < end && *p != '\n') ++p;
    return p < end ? p + 1 : end;
}

inline const char* parse_ll(const char* p, const char* end, int64_t* out) {
    p = skip_ws(p, end);
    bool neg = false;
    if (p < end && (*p == '-' || *p == '+')) { neg = *p == '-'; ++p; }
    int64_t v = 0;
    const char* start = p;
    while (p < end && *p >= '0' && *p <= '9') { v = v * 10 + (*p - '0'); ++p; }
    if (p == start) return nullptr;
    *out = neg ? -v : v;
    return p;
}

inline const char* parse_double(const char* p, const char* end, double* out) {
    // skip_ws is the only whitespace consumer: strtod would also skip
    // newlines, so a short line would silently bleed into the next row.
    p = skip_ws(p, end);
    if (p >= end || *p == '\n') return nullptr;
    char* q = nullptr;
    // the buffer is NUL-terminated (see above), so strtod cannot overrun
    *out = strtod(p, &q);
    if (q == p) return nullptr;
    return q;
}

}  // namespace

extern "C" {

// Parse up to max_entries lines of "int int [double [double]]" after
// skipping skip_lines lines.  ncols selects the line shape:
//   2 -> rows, cols            (pattern)
//   3 -> rows, cols, vals
//   4 -> rows, cols, vals(re), vals(im)  (imag stored to vals2)
int64_t fastio_parse_triplets(const char* data, int64_t size,
                              int64_t skip_lines, int32_t ncols,
                              int64_t max_entries, int64_t* rows,
                              int64_t* cols, double* vals, double* vals2) {
    const char* p = data;
    const char* end = data + size;
    for (int64_t i = 0; i < skip_lines && p < end; ++i) p = skip_line(p, end);
    int64_t n = 0;
    while (p < end && n < max_entries) {
        p = skip_ws(p, end);
        if (p >= end) break;
        if (*p == '\n') { ++p; continue; }
        if (*p == '%' || *p == '#') { p = skip_line(p, end); continue; }
        int64_t r, c;
        const char* q = parse_ll(p, end, &r);
        if (!q) { p = skip_line(p, end); continue; }
        q = parse_ll(q, end, &c);
        if (!q) { p = skip_line(p, end); continue; }
        double v = 1.0, v2 = 0.0;
        if (ncols >= 3) {
            q = parse_double(q, end, &v);
            if (!q) { p = skip_line(p, end); continue; }
        }
        if (ncols >= 4) {
            q = parse_double(q, end, &v2);
            if (!q) { p = skip_line(p, end); continue; }
        }
        rows[n] = r;
        cols[n] = c;
        if (vals) vals[n] = v;
        if (vals2) vals2[n] = v2;
        ++n;
        p = skip_line(q, end);
    }
    return n;
}

// Parse "int double" pair lines (HYPRE-IJ vector bodies).
int64_t fastio_parse_pairs(const char* data, int64_t size, int64_t skip_lines,
                           int64_t max_entries, int64_t* idx, double* vals) {
    const char* p = data;
    const char* end = data + size;
    for (int64_t i = 0; i < skip_lines && p < end; ++i) p = skip_line(p, end);
    int64_t n = 0;
    while (p < end && n < max_entries) {
        p = skip_ws(p, end);
        if (p >= end) break;
        if (*p == '\n') { ++p; continue; }
        if (*p == '%' || *p == '#') { p = skip_line(p, end); continue; }
        int64_t i;
        const char* q = parse_ll(p, end, &i);
        if (!q) { p = skip_line(p, end); continue; }
        double v;
        q = parse_double(q, end, &v);
        if (!q) { p = skip_line(p, end); continue; }
        idx[n] = i;
        vals[n] = v;
        ++n;
        p = skip_line(q, end);
    }
    return n;
}

// Parse single- or double-column float lines (MM array vector bodies).
// width 1 -> vals only; width 2 -> vals + vals2 (complex).
int64_t fastio_parse_floats(const char* data, int64_t size,
                            int64_t skip_lines, int32_t width,
                            int64_t max_entries, double* vals,
                            double* vals2) {
    const char* p = data;
    const char* end = data + size;
    for (int64_t i = 0; i < skip_lines && p < end; ++i) p = skip_line(p, end);
    int64_t n = 0;
    while (p < end && n < max_entries) {
        p = skip_ws(p, end);
        if (p >= end) break;
        if (*p == '\n') { ++p; continue; }
        if (*p == '%' || *p == '#') { p = skip_line(p, end); continue; }
        double v;
        const char* q = parse_double(p, end, &v);
        if (!q) { p = skip_line(p, end); continue; }
        double v2 = 0.0;
        if (width >= 2) {
            q = parse_double(q, end, &v2);
            if (!q) { p = skip_line(p, end); continue; }
        }
        vals[n] = v;
        if (vals2) vals2[n] = v2;
        ++n;
        p = skip_line(q, end);
    }
    return n;
}

}  // extern "C"
