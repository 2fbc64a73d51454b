// tifffast — minimal 16-bit grayscale TIFF decode/encode + threaded batch IO.
//
// Native replacement for the host-side hot path of the input pipeline: the
// reference burns 4 DataLoader worker processes on PIL decode
// (train_swin.py:142-145); here a C++ thread pool decodes straight into the
// caller's pinned batch buffer with zero Python-object overhead.
//
// Scope: the TIFFs this framework writes and reads (PIL 'I;16'):
// uncompressed, little- or big-endian, 16-bit single-channel, strip-based.
// Anything else returns an error and the Python wrapper falls back to PIL.
//
// Build: g++ -O3 -shared -fPIC -o libtifffast.so tifffast.cpp -lpthread
// (data/fast_tiff.py builds it so at first use, into the package's _build/).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>
#include <atomic>

namespace {

struct Reader {
  const uint8_t* p;
  size_t n;
  bool le;  // little-endian file

  uint16_t u16(size_t off) const {
    if (off + 2 > n) return 0;
    return le ? (uint16_t)(p[off] | p[off + 1] << 8)
              : (uint16_t)(p[off] << 8 | p[off + 1]);
  }
  uint32_t u32(size_t off) const {
    if (off + 4 > n) return 0;
    return le ? ((uint32_t)p[off] | (uint32_t)p[off + 1] << 8 |
                 (uint32_t)p[off + 2] << 16 | (uint32_t)p[off + 3] << 24)
              : ((uint32_t)p[off] << 24 | (uint32_t)p[off + 1] << 16 |
                 (uint32_t)p[off + 2] << 8 | (uint32_t)p[off + 3]);
  }
};

struct Tag {
  uint16_t id;
  uint16_t type;
  uint32_t count;
  uint32_t value_off;  // inline value or offset
};

// TIFF type sizes: BYTE=1, ASCII=1, SHORT=2, LONG=4 ...
int type_size(uint16_t t) {
  switch (t) {
    case 1: case 2: case 6: case 7: return 1;
    case 3: case 8: return 2;
    case 4: case 9: case 11: return 4;
    case 5: case 10: case 12: return 8;
    default: return 0;
  }
}

// Read tag value i (SHORT or LONG) handling inline-vs-offset storage.
uint32_t tag_value(const Reader& r, const Tag& t, uint32_t i) {
  int ts = type_size(t.type);
  size_t total = (size_t)ts * t.count;
  size_t base;
  if (total <= 4) {
    // value stored inline in the 4 value bytes of the IFD entry
    base = t.value_off;  // value_off here is the FILE OFFSET of those bytes
  } else {
    base = r.u32(t.value_off);
  }
  size_t off = base + (size_t)ts * i;
  if (t.type == 3) return r.u16(off);
  return r.u32(off);
}

}  // namespace

extern "C" {

// Decode one 16-bit grayscale TIFF. Returns 0 on success; fills out[h*w].
// Negative codes: -1 io, -2 not tiff, -3 unsupported layout, -4 shape mismatch.
int tiff_read_u16(const char* path, uint16_t* out, int32_t expect_h,
                  int32_t expect_w) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  long sz = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (sz < 8) { std::fclose(f); return -2; }
  std::vector<uint8_t> buf((size_t)sz);
  if (std::fread(buf.data(), 1, (size_t)sz, f) != (size_t)sz) {
    std::fclose(f);
    return -1;
  }
  std::fclose(f);

  Reader r{buf.data(), (size_t)sz, true};
  if (buf[0] == 'I' && buf[1] == 'I') r.le = true;
  else if (buf[0] == 'M' && buf[1] == 'M') r.le = false;
  else return -2;
  if (r.u16(2) != 42) return -2;

  uint32_t ifd = r.u32(4);
  if (ifd + 2 > (uint32_t)sz) return -2;
  uint16_t ntags = r.u16(ifd);

  uint32_t width = 0, height = 0, bits = 1, comp = 1, spp = 1, rows_per_strip = 0;
  Tag offsets{}, counts{};
  bool have_off = false, have_cnt = false;

  for (uint16_t i = 0; i < ntags; i++) {
    size_t e = ifd + 2 + (size_t)i * 12;
    Tag t{r.u16(e), r.u16(e + 2), r.u32(e + 4), 0};
    // keep the FILE OFFSET of the inline value bytes for tag_value()
    size_t total = (size_t)type_size(t.type) * t.count;
    t.value_off = (total <= 4) ? (uint32_t)(e + 8) : (uint32_t)(e + 8);
    // for >4 bytes, tag_value dereferences; keep e+8 either way
    switch (t.id) {
      case 256: width = tag_value(r, t, 0); break;
      case 257: height = tag_value(r, t, 0); break;
      case 258: bits = tag_value(r, t, 0); break;
      case 259: comp = tag_value(r, t, 0); break;
      case 277: spp = tag_value(r, t, 0); break;
      case 278: rows_per_strip = tag_value(r, t, 0); break;
      case 273: offsets = t; have_off = true; break;
      case 279: counts = t; have_cnt = true; break;
      default: break;
    }
  }
  if (comp != 1 || bits != 16 || spp != 1 || !have_off || !width || !height)
    return -3;
  if ((expect_h >= 0 && (uint32_t)expect_h != height) ||
      (expect_w >= 0 && (uint32_t)expect_w != width))
    return -4;
  if (!rows_per_strip || rows_per_strip > height) rows_per_strip = height;

  size_t row_bytes = (size_t)width * 2;
  uint32_t nstrips = offsets.count;
  uint32_t row = 0;
  for (uint32_t s = 0; s < nstrips && row < height; s++) {
    uint32_t off = tag_value(r, offsets, s);
    uint32_t rows = rows_per_strip;
    if (row + rows > height) rows = height - row;
    size_t nbytes = row_bytes * rows;
    if (have_cnt) {
      uint32_t c = tag_value(r, counts, s);
      if (c < nbytes) nbytes = c;
    }
    if (off + nbytes > (size_t)sz) return -3;
    if (r.le) {
      std::memcpy(out + (size_t)row * width, buf.data() + off, nbytes);
    } else {
      const uint8_t* src = buf.data() + off;
      uint16_t* dst = out + (size_t)row * width;
      for (size_t j = 0; j < nbytes / 2; j++)
        dst[j] = (uint16_t)(src[2 * j] << 8 | src[2 * j + 1]);
    }
    row += rows;
  }
  return 0;
}

// Threaded batch decode: n files into out[n*h*w]. status[i] = per-file code.
void tiff_read_batch_u16(const char** paths, int32_t n, uint16_t* out,
                         int32_t h, int32_t w, int32_t nthreads,
                         int32_t* status) {
  if (nthreads < 1) nthreads = 1;
  std::atomic<int32_t> next{0};
  auto work = [&]() {
    for (;;) {
      int32_t i = next.fetch_add(1);
      if (i >= n) break;
      status[i] = tiff_read_u16(paths[i], out + (size_t)i * h * w, h, w);
    }
  };
  std::vector<std::thread> ts;
  for (int32_t t = 0; t < nthreads && t < n; t++) ts.emplace_back(work);
  for (auto& t : ts) t.join();
}

// Write an uncompressed little-endian 16-bit grayscale TIFF (one strip).
int tiff_write_u16(const char* path, const uint16_t* data, int32_t h,
                   int32_t w) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  // header(8) + pixel data + IFD
  uint32_t data_off = 8;
  uint32_t data_bytes = (uint32_t)h * w * 2;
  uint32_t ifd_off = data_off + data_bytes;

  uint8_t head[8] = {'I', 'I', 42, 0, 0, 0, 0, 0};
  std::memcpy(head + 4, &ifd_off, 4);
  std::fwrite(head, 1, 8, f);
  std::fwrite(data, 2, (size_t)h * w, f);

  struct E { uint16_t id, type; uint32_t count, value; };
  E entries[] = {
      {256, 4, 1, (uint32_t)w},          // ImageWidth
      {257, 4, 1, (uint32_t)h},          // ImageLength
      {258, 3, 1, 16},                   // BitsPerSample
      {259, 3, 1, 1},                    // Compression: none
      {262, 3, 1, 1},                    // Photometric: BlackIsZero
      {273, 4, 1, data_off},             // StripOffsets
      {277, 3, 1, 1},                    // SamplesPerPixel
      {278, 4, 1, (uint32_t)h},          // RowsPerStrip
      {279, 4, 1, data_bytes},           // StripByteCounts
  };
  uint16_t ntags = sizeof(entries) / sizeof(entries[0]);
  std::fwrite(&ntags, 2, 1, f);
  for (auto& e : entries) {
    std::fwrite(&e.id, 2, 1, f);
    std::fwrite(&e.type, 2, 1, f);
    std::fwrite(&e.count, 4, 1, f);
    std::fwrite(&e.value, 4, 1, f);
  }
  uint32_t zero = 0;
  std::fwrite(&zero, 4, 1, f);  // next IFD
  std::fclose(f);
  return 0;
}

}  // extern "C"
