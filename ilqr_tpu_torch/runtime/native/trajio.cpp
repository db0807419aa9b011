// Native trajectory I/O for ilqr_tpu_torch (a copy of
// ilqr_tpu/runtime/native/trajio.cpp: the same byte formats).
//
// The reference writes its converged trajectory with ofstream per-element
// formatting (ref: src/ilqr_core.cpp:414-431) — fine for one solve, far too
// slow for logging thousands of batched MPC solutions per second. This
// module provides:
//   - the reference-compatible CSV format (header x1..xn,u1..um; T rows of
//     state+control; one final state-only row), and
//   - a packed binary format (magic "ILQT", little-endian) for high-rate
//     batched trajectory logging with one fwrite per solution.
//
// Exposed with a plain C ABI for ctypes (no pybind11 in this toolchain);
// built with g++ at first use by ilqr_tpu_torch/runtime/trajio.py.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct BinHeader {
  char magic[4];      // "ILQT"
  std::uint32_t version;
  std::uint32_t n;    // state dims
  std::uint32_t m;    // control dims
  std::uint32_t T;    // horizon (controls rows); states rows = T+1
  std::uint32_t count;  // number of trajectories in the file
};

constexpr std::uint32_t kVersion = 1;

}  // namespace

extern "C" {

// Returns 0 on success, negative errno-style code on failure.
int ilqt_write_csv(const char* path, const double* xs, const double* us,
                   int T, int n, int m) {
  std::FILE* f = std::fopen(path, "w");
  if (!f) return -1;

  std::string header;
  char buf[64];
  for (int i = 0; i < n; ++i) {
    std::snprintf(buf, sizeof(buf), "x%d", i + 1);
    header += buf;
    header += ", ";
  }
  for (int j = 0; j < m; ++j) {
    std::snprintf(buf, sizeof(buf), "u%d", j + 1);
    header += buf;
    if (j + 1 < m) header += ", ";
  }
  header += "\n";
  std::fputs(header.c_str(), f);

  // One big row buffer; %f matches the reference's default precision.
  std::string row;
  row.reserve(32 * (n + m));
  for (int t = 0; t < T; ++t) {
    row.clear();
    for (int i = 0; i < n; ++i) {
      std::snprintf(buf, sizeof(buf), "%f, ", xs[t * n + i]);
      row += buf;
    }
    for (int j = 0; j < m; ++j) {
      std::snprintf(buf, sizeof(buf), j + 1 < m ? "%f, " : "%f\n",
                    us[t * m + j]);
      row += buf;
    }
    std::fputs(row.c_str(), f);
  }
  row.clear();
  for (int i = 0; i < n; ++i) {
    std::snprintf(buf, sizeof(buf), i + 1 < n ? "%f, " : "%f\n",
                  xs[T * n + i]);
    row += buf;
  }
  std::fputs(row.c_str(), f);
  std::fclose(f);
  return 0;
}

// Binary batch writer: `count` trajectories, xs laid out (count, T+1, n),
// us (count, T, m), both C-contiguous double.
int ilqt_write_bin(const char* path, const double* xs, const double* us,
                   int count, int T, int n, int m) {
  std::FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  BinHeader h;
  std::memcpy(h.magic, "ILQT", 4);
  h.version = kVersion;
  h.n = static_cast<std::uint32_t>(n);
  h.m = static_cast<std::uint32_t>(m);
  h.T = static_cast<std::uint32_t>(T);
  h.count = static_cast<std::uint32_t>(count);
  if (std::fwrite(&h, sizeof(h), 1, f) != 1) { std::fclose(f); return -2; }
  const size_t xs_len = static_cast<size_t>(count) * (T + 1) * n;
  const size_t us_len = static_cast<size_t>(count) * T * m;
  if (std::fwrite(xs, sizeof(double), xs_len, f) != xs_len) {
    std::fclose(f); return -3;
  }
  if (std::fwrite(us, sizeof(double), us_len, f) != us_len) {
    std::fclose(f); return -4;
  }
  std::fclose(f);
  return 0;
}

// Reads header only; returns 0 and fills (count, T, n, m) on success.
int ilqt_read_bin_header(const char* path, int* count, int* T, int* n,
                         int* m) {
  std::FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  BinHeader h;
  if (std::fread(&h, sizeof(h), 1, f) != 1 ||
      std::memcmp(h.magic, "ILQT", 4) != 0 || h.version != kVersion) {
    std::fclose(f);
    return -2;
  }
  *count = static_cast<int>(h.count);
  *T = static_cast<int>(h.T);
  *n = static_cast<int>(h.n);
  *m = static_cast<int>(h.m);
  std::fclose(f);
  return 0;
}

// Reads payload into caller-allocated buffers (sized from the header).
int ilqt_read_bin(const char* path, double* xs, double* us) {
  std::FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  BinHeader h;
  if (std::fread(&h, sizeof(h), 1, f) != 1 ||
      std::memcmp(h.magic, "ILQT", 4) != 0) {
    std::fclose(f);
    return -2;
  }
  const size_t xs_len =
      static_cast<size_t>(h.count) * (h.T + 1) * h.n;
  const size_t us_len = static_cast<size_t>(h.count) * h.T * h.m;
  if (std::fread(xs, sizeof(double), xs_len, f) != xs_len) {
    std::fclose(f); return -3;
  }
  if (std::fread(us, sizeof(double), us_len, f) != us_len) {
    std::fclose(f); return -4;
  }
  std::fclose(f);
  return 0;
}

}  // extern "C"
