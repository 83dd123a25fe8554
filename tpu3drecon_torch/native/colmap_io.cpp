// Native COLMAP binary sparse-model parser.
//
// The runtime's data-loading fast path: the reference spends its ingest time
// building per-point Python objects (reference: src/dataset/loaders/
// colmap_dataset_loader/*.py — 100k+ dataclass allocations per scene); even
// our vectorized numpy reader must walk the ragged record stream in Python
// (one struct.unpack per image/point).  This parser walks the stream in C++
// and fills caller-allocated flat arrays (the CSR layout of
// tpu3drecon_torch/io/colmap/records.py) directly.
//
// Two-call protocol per file, so Python owns all allocations:
//   1. scan:  sizes of the ragged sections
//   2. parse: fill numpy-backed buffers
// All multi-byte values are little-endian (COLMAP's format); this code
// assumes a little-endian host (x86-64 / aarch64).
//
// Build: tpu3drecon_torch/io/colmap/native.py compiles this file with g++
// into tpu3drecon_torch/_build/ at first use.

#include <charconv>
#include <cstdint>
#include <cstring>

namespace {

struct Cursor {
  const uint8_t* p;
  const uint8_t* end;

  bool ok(uint64_t n) const { return static_cast<uint64_t>(end - p) >= n; }

  // Overflow-safe variant for count*size records: `count * size` can wrap
  // uint64 on a corrupt/crafted file and defeat the bounds check, so divide
  // instead of multiplying.
  bool ok_count(uint64_t count, uint64_t size) const {
    return count <= static_cast<uint64_t>(end - p) / size;
  }

  bool skip_count(uint64_t count, uint64_t size) {
    if (!ok_count(count, size)) return false;
    p += count * size;
    return true;
  }

  template <typename T>
  bool read(T* out) {
    if (!ok(sizeof(T))) return false;
    std::memcpy(out, p, sizeof(T));
    p += sizeof(T);
    return true;
  }

  bool skip(uint64_t n) {
    if (!ok(n)) return false;
    p += n;
    return true;
  }
};

constexpr int kOk = 0;
constexpr int kErrTruncated = 1;
constexpr int kErrBadString = 2;

}  // namespace

extern "C" {

// ---------------- points3D.bin ----------------
// Record: id u64, xyz 3xf64, rgb 3xu8, error f64, track_len u64,
//         then track_len x { image_id i32, p2d_idx i32 }.

int colmap_scan_points3d(const uint8_t* buf, uint64_t len,
                         uint64_t* num_points, uint64_t* total_track) {
  Cursor c{buf, buf + len};
  uint64_t n;
  if (!c.read(&n)) return kErrTruncated;
  uint64_t track_total = 0;
  for (uint64_t i = 0; i < n; ++i) {
    if (!c.skip(8 + 24 + 3 + 8)) return kErrTruncated;
    uint64_t track_len;
    if (!c.read(&track_len)) return kErrTruncated;
    if (!c.skip_count(track_len, 8)) return kErrTruncated;
    track_total += track_len;
  }
  *num_points = n;
  *total_track = track_total;
  return kOk;
}

int colmap_parse_points3d(const uint8_t* buf, uint64_t len, int64_t* ids,
                          double* xyz, uint8_t* rgb, double* error,
                          int64_t* track_offsets, int32_t* track_image_ids,
                          int32_t* track_p2d_idxs) {
  Cursor c{buf, buf + len};
  uint64_t n;
  if (!c.read(&n)) return kErrTruncated;
  uint64_t toff = 0;
  track_offsets[0] = 0;
  for (uint64_t i = 0; i < n; ++i) {
    uint64_t id;
    if (!c.read(&id)) return kErrTruncated;
    ids[i] = static_cast<int64_t>(id);
    if (!c.ok(24 + 3 + 8 + 8)) return kErrTruncated;
    std::memcpy(xyz + 3 * i, c.p, 24);
    c.p += 24;
    std::memcpy(rgb + 3 * i, c.p, 3);
    c.p += 3;
    std::memcpy(error + i, c.p, 8);
    c.p += 8;
    uint64_t track_len = 0;
    if (!c.read(&track_len)) return kErrTruncated;
    if (!c.ok_count(track_len, 8)) return kErrTruncated;
    for (uint64_t t = 0; t < track_len; ++t) {
      std::memcpy(track_image_ids + toff + t, c.p + 8 * t, 4);
      std::memcpy(track_p2d_idxs + toff + t, c.p + 8 * t + 4, 4);
    }
    c.p += track_len * 8;
    toff += track_len;
    track_offsets[i + 1] = static_cast<int64_t>(toff);
  }
  return kOk;
}

// ---------------- images.bin ----------------
// Record: image_id i32, qvec 4xf64, tvec 3xf64, camera_id i32,
//         name bytes until NUL, num_p2d u64,
//         then num_p2d x { x f64, y f64, point3d_id i64 }.

int colmap_scan_images(const uint8_t* buf, uint64_t len, uint64_t* num_images,
                       uint64_t* total_p2d, uint64_t* total_name_bytes) {
  Cursor c{buf, buf + len};
  uint64_t n;
  if (!c.read(&n)) return kErrTruncated;
  uint64_t p2d_total = 0, name_total = 0;
  for (uint64_t i = 0; i < n; ++i) {
    if (!c.skip(4 + 32 + 24 + 4)) return kErrTruncated;
    const uint8_t* nul =
        static_cast<const uint8_t*>(std::memchr(c.p, 0, c.end - c.p));
    if (nul == nullptr) return kErrBadString;
    name_total += static_cast<uint64_t>(nul - c.p);
    c.p = nul + 1;
    uint64_t n_p2d;
    if (!c.read(&n_p2d)) return kErrTruncated;
    if (!c.skip_count(n_p2d, 24)) return kErrTruncated;
    p2d_total += n_p2d;
  }
  *num_images = n;
  *total_p2d = p2d_total;
  *total_name_bytes = name_total;
  return kOk;
}

int colmap_parse_images(const uint8_t* buf, uint64_t len, int32_t* image_ids,
                        double* qvecs, double* tvecs, int32_t* camera_ids,
                        uint8_t* name_bytes, int64_t* name_offsets,
                        int64_t* p2d_offsets, double* p2d_xy,
                        int64_t* p2d_point3d_ids) {
  Cursor c{buf, buf + len};
  uint64_t n;
  if (!c.read(&n)) return kErrTruncated;
  uint64_t p2d_off = 0, name_off = 0;
  p2d_offsets[0] = 0;
  name_offsets[0] = 0;
  for (uint64_t i = 0; i < n; ++i) {
    if (!c.read(image_ids + i)) return kErrTruncated;
    if (!c.ok(32 + 24 + 4)) return kErrTruncated;
    std::memcpy(qvecs + 4 * i, c.p, 32);
    c.p += 32;
    std::memcpy(tvecs + 3 * i, c.p, 24);
    c.p += 24;
    std::memcpy(camera_ids + i, c.p, 4);
    c.p += 4;
    const uint8_t* nul =
        static_cast<const uint8_t*>(std::memchr(c.p, 0, c.end - c.p));
    if (nul == nullptr) return kErrBadString;
    uint64_t name_len = static_cast<uint64_t>(nul - c.p);
    std::memcpy(name_bytes + name_off, c.p, name_len);
    name_off += name_len;
    name_offsets[i + 1] = static_cast<int64_t>(name_off);
    c.p = nul + 1;
    uint64_t n_p2d;
    if (!c.read(&n_p2d)) return kErrTruncated;
    if (!c.ok_count(n_p2d, 24)) return kErrTruncated;
    for (uint64_t k = 0; k < n_p2d; ++k) {
      std::memcpy(p2d_xy + 2 * (p2d_off + k), c.p + 24 * k, 16);
      std::memcpy(p2d_point3d_ids + p2d_off + k, c.p + 24 * k + 16, 8);
    }
    c.p += n_p2d * 24;
    p2d_off += n_p2d;
    p2d_offsets[i + 1] = static_cast<int64_t>(p2d_off);
  }
  return kOk;
}

}  // extern "C"

// ---------------- BAL text files ----------------
// BAL ("Bundle Adjustment in the Large") problems are whitespace-delimited
// decimal text, often ~100 MB for the large problems; Python's
// str.split + np.array tokenization is the ingest bottleneck.  This parses
// every token with std::from_chars in one pass into a caller-allocated
// double array.

extern "C" int bal_parse_doubles(const char* buf, uint64_t len, double* out,
                                 uint64_t n_expected, uint64_t* n_parsed) {
  const char* p = buf;
  const char* end = buf + len;
  uint64_t n = 0;
  while (p < end && n < n_expected) {
    // Skip whitespace.
    while (p < end && (*p == ' ' || *p == '\n' || *p == '\r' || *p == '\t')) ++p;
    if (p >= end) break;
    double v;
    auto res = std::from_chars(p, end, v);
    if (res.ec != std::errc()) {
      *n_parsed = n;
      return 3;  // bad token
    }
    out[n++] = v;
    p = res.ptr;
  }
  *n_parsed = n;
  return n == n_expected ? 0 : 1;  // kOk / kErrTruncated
}
