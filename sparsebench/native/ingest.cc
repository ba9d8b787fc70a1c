// Native host-side ingest kernels for sparsebench.
//
// Counterpart of the reference's C host layer: the HPCG stencil
// generator (reference src/matrix.c:30-121), the Matrix Market parser
// (src/mmio.c + src/matrix.c:123-229), and the SELL-C-sigma fill loop
// (src/matrix-SCS.c:165-196). The Python numpy implementations in
// sparsebench/host are the behavioral spec; these replace them 1:1 for
// speed on benchmark-scale problems (a 200^3 generator call is ~870 MB of
// output; numpy takes minutes, this takes seconds).
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in this
// environment). All output buffers are allocated by the caller (numpy);
// functions return actual element counts or negative error codes.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Stencil generator (reference src/matrix.c:30-121).
// row_ptr: int64[local_nrow+1]; col: int32[27*local_nrow];
// val32/val64: exactly one non-null, capacity 27*local_nrow.
// Returns actual nnz.
int64_t sb_generate_stencil(int32_t nx, int32_t ny, int32_t nz, int32_t rank,
                            int32_t size, int32_t use_7pt, int64_t* row_ptr,
                            int32_t* col, float* val32, double* val64) {
  const int64_t local_nrow = (int64_t)nx * ny * nz;
  const int64_t total_nrow = local_nrow * size;
  const int64_t start_row = local_nrow * rank;
  const int64_t plane = (int64_t)nx * ny;

  // Precompute the (sz, sy, sx) offset list in reference loop order.
  int64_t offs[27];
  int8_t osx[27], osy[27];
  int noff = 0;
  for (int sz = -1; sz <= 1; ++sz)
    for (int sy = -1; sy <= 1; ++sy)
      for (int sx = -1; sx <= 1; ++sx) {
        if (use_7pt && sz * sz + sy * sy + sx * sx > 1) continue;
        offs[noff] = (int64_t)sz * plane + (int64_t)sy * nx + sx;
        osx[noff] = (int8_t)sx;
        osy[noff] = (int8_t)sy;
        ++noff;
      }

  int64_t cursor = 0;
  row_ptr[0] = 0;
  int64_t row_id = 0;
  for (int32_t iz = 0; iz < nz; ++iz) {
    for (int32_t iy = 0; iy < ny; ++iy) {
      for (int32_t ix = 0; ix < nx; ++ix, ++row_id) {
        const int64_t currow = start_row + row_id;
        for (int k = 0; k < noff; ++k) {
          const int32_t jx = ix + osx[k];
          const int32_t jy = iy + osy[k];
          if (jx < 0 || jx >= nx || jy < 0 || jy >= ny) continue;
          const int64_t curcol = currow + offs[k];
          if (curcol < 0 || curcol >= total_nrow) continue;
          col[cursor] = (int32_t)curcol;
          if (val32)
            val32[cursor] = (curcol == currow) ? 27.0f : -1.0f;
          else
            val64[cursor] = (curcol == currow) ? 27.0 : -1.0;
          ++cursor;
        }
        row_ptr[row_id + 1] = cursor;
      }
    }
  }
  return cursor;
}

// ---------------------------------------------------------------------------
// Matrix Market body parser. The caller (Python) reads the banner/size line
// and hands over the file offset of the first entry plus the entry count
// and flags. Fills row/col/val (capacity nz, or 2*nz when symmetric
// mirroring is requested) and returns the entry count after mirroring.
// pattern: values forced to 1.0. Returns -1 on parse error, -2 on I/O.
int64_t sb_mm_parse_body(const char* path, int64_t body_offset, int64_t nz,
                         int32_t pattern, int32_t symmetric, int64_t* row,
                         int64_t* col, double* val) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -2;
  if (std::fseek(f, (long)body_offset, SEEK_SET) != 0) {
    std::fclose(f);
    return -2;
  }
  // Slurp the rest of the file.
  std::fseek(f, 0, SEEK_END);
  const long end = std::ftell(f);
  std::fseek(f, (long)body_offset, SEEK_SET);
  std::vector<char> buf((size_t)(end - body_offset) + 1);
  const size_t got = std::fread(buf.data(), 1, buf.size() - 1, f);
  std::fclose(f);
  buf[got] = '\0';

  const char* p = buf.data();
  char* q = nullptr;
  int64_t cursor = 0;
  for (int64_t i = 0; i < nz; ++i) {
    const long r = std::strtol(p, &q, 10);
    if (q == p) return -1;
    p = q;
    const long c = std::strtol(p, &q, 10);
    if (q == p) return -1;
    p = q;
    double v = 1.0;
    if (!pattern) {
      v = std::strtod(p, &q);
      if (q == p) return -1;
      p = q;
    }
    row[cursor] = r - 1;  // 1-based -> 0-based (reference matrix.c:200-201)
    col[cursor] = c - 1;
    val[cursor] = v;
    ++cursor;
    if (symmetric && r != c) {  // mirror (reference matrix.c:204-208)
      row[cursor] = c - 1;
      col[cursor] = r - 1;
      val[cursor] = v;
      ++cursor;
    }
  }
  return cursor;
}

// ---------------------------------------------------------------------------
// Row-major (row, col) sort of COO entries, in place. Equivalent to the
// reference's qsort-by-col + stable-qsort-by-row (src/matrix.c:219-228).
void sb_coo_sort(int64_t n, int64_t* row, int64_t* col, double* val) {
  std::vector<int64_t> perm(n);
  for (int64_t i = 0; i < n; ++i) perm[i] = i;
  std::sort(perm.begin(), perm.end(), [&](int64_t a, int64_t b) {
    if (row[a] != row[b]) return row[a] < row[b];
    return col[a] < col[b];
  });
  std::vector<int64_t> tmp_i(n);
  std::vector<double> tmp_d(n);
  for (int64_t i = 0; i < n; ++i) tmp_i[i] = row[perm[i]];
  std::memcpy(row, tmp_i.data(), n * sizeof(int64_t));
  for (int64_t i = 0; i < n; ++i) tmp_i[i] = col[perm[i]];
  std::memcpy(col, tmp_i.data(), n * sizeof(int64_t));
  for (int64_t i = 0; i < n; ++i) tmp_d[i] = val[perm[i]];
  std::memcpy(val, tmp_d.data(), n * sizeof(double));
}

// ---------------------------------------------------------------------------
// SELL-C-sigma flat fill (reference src/matrix-SCS.c:165-196): scatter CSR
// entries into the chunk-column-major flat layout given the row permutation
// and chunk pointers. Types match the host conversion (int64 indices).
void sb_sell_fill(int64_t nr, const int64_t* row_ptr, const int64_t* csr_col,
                  const double* csr_val, const int64_t* old_to_new,
                  const int64_t* chunk_ptr, int64_t C, int64_t* out_col,
                  double* out_val) {
  for (int64_t i = 0; i < nr; ++i) {
    const int64_t rnew = old_to_new[i];
    const int64_t chunk = rnew / C;
    const int64_t lane = rnew % C;
    const int64_t base = chunk_ptr[chunk] + lane;
    int64_t j = 0;
    for (int64_t e = row_ptr[i]; e < row_ptr[i + 1]; ++e, ++j) {
      const int64_t idx = base + j * C;
      out_col[idx] = csr_col[e];
      out_val[idx] = csr_val[e];
    }
  }
}


}  // extern "C"
