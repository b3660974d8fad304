// Native code store of the PyTorch port: mmap'd reads and a thread-parallel
// batch gather over the fixed-record `.vq2` file, bound with ctypes by
// vqvae2_tpu_torch/data/codestore.py, which builds it with g++ at first use
// into vqvae2_tpu_torch/data/_built/.
//
// The port's own copy of native/codestore.cpp (the JAX package's native code
// store, built there by native/Makefile); the code below the includes is that
// file's, unchanged, so both packages read and write the same bytes.
//
// Design: fixed-record binary file, mmap'd read path, zero-copy batch gather
// into caller-provided buffers (the hot path feeding the stage-2 prior
// trainer). No pickling, no per-item transactions: a batch gather is a
// sequence of memcpys from the page cache, parallelized across threads.
//
// Layout (little-endian, matches the numpy backend of codestore.py):
//   header: 8s magic "VQ2CODES" | i64 version | i64 count
//           | i64 top_h | i64 top_w | i64 bot_h | i64 bot_w     (56 bytes)
//   record: top  int16[top_h*top_w]
//           bottom int16[bot_h*bot_w]
//           label int32
//           name  char[64]
//
// C API only.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

constexpr char kMagic[8] = {'V', 'Q', '2', 'C', 'O', 'D', 'E', 'S'};
constexpr int64_t kVersion = 1;
constexpr size_t kHeaderSize = 56;
constexpr size_t kNameLen = 64;

struct Header {
  char magic[8];
  int64_t version;
  int64_t count;
  int64_t top_h, top_w, bot_h, bot_w;
};

struct Store {
  int fd = -1;
  uint8_t* map = nullptr;
  size_t map_size = 0;
  Header hdr{};
  size_t top_bytes = 0, bot_bytes = 0, rec_bytes = 0;
  FILE* write_fp = nullptr;  // writer mode
  char path[4096];
};

size_t record_bytes(const Header& h) {
  return sizeof(int16_t) * (h.top_h * h.top_w + h.bot_h * h.bot_w) +
         sizeof(int32_t) + kNameLen;
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------- writer ---
void* cs_create(const char* path, int64_t top_h, int64_t top_w, int64_t bot_h,
                int64_t bot_w) {
  auto* s = new Store();
  snprintf(s->path, sizeof(s->path), "%s", path);
  s->hdr = Header{{}, kVersion, 0, top_h, top_w, bot_h, bot_w};
  memcpy(s->hdr.magic, kMagic, 8);
  s->top_bytes = sizeof(int16_t) * top_h * top_w;
  s->bot_bytes = sizeof(int16_t) * bot_h * bot_w;
  s->rec_bytes = record_bytes(s->hdr);
  s->write_fp = fopen(path, "wb");
  if (!s->write_fp) {
    delete s;
    return nullptr;
  }
  fwrite(&s->hdr, 1, kHeaderSize, s->write_fp);  // placeholder; fixed on close
  return s;
}

// Append n records. tops: int16[n, top_h*top_w]; bottoms likewise;
// labels: int32[n]; names: char[n][64] (zero-padded).
int64_t cs_append(void* handle, int64_t n, const int16_t* tops,
                  const int16_t* bottoms, const int32_t* labels,
                  const char* names) {
  auto* s = static_cast<Store*>(handle);
  if (!s->write_fp) return -1;
  const int64_t tlen = s->hdr.top_h * s->hdr.top_w;
  const int64_t blen = s->hdr.bot_h * s->hdr.bot_w;
  for (int64_t i = 0; i < n; ++i) {
    fwrite(tops + i * tlen, sizeof(int16_t), tlen, s->write_fp);
    fwrite(bottoms + i * blen, sizeof(int16_t), blen, s->write_fp);
    fwrite(labels + i, sizeof(int32_t), 1, s->write_fp);
    fwrite(names + i * kNameLen, 1, kNameLen, s->write_fp);
  }
  s->hdr.count += n;
  return s->hdr.count;
}

int64_t cs_finalize(void* handle) {
  auto* s = static_cast<Store*>(handle);
  if (!s->write_fp) return -1;
  fseek(s->write_fp, 0, SEEK_SET);
  fwrite(&s->hdr, 1, kHeaderSize, s->write_fp);
  fclose(s->write_fp);
  s->write_fp = nullptr;
  int64_t count = s->hdr.count;
  delete s;
  return count;
}

// ---------------------------------------------------------------- reader ---
void* cs_open(const char* path) {
  auto* s = new Store();
  s->fd = open(path, O_RDONLY);
  if (s->fd < 0) {
    delete s;
    return nullptr;
  }
  struct stat st;
  fstat(s->fd, &st);
  s->map_size = st.st_size;
  s->map = static_cast<uint8_t*>(
      mmap(nullptr, s->map_size, PROT_READ, MAP_SHARED, s->fd, 0));
  if (s->map == MAP_FAILED) {
    close(s->fd);
    delete s;
    return nullptr;
  }
  madvise(s->map, s->map_size, MADV_WILLNEED);
  memcpy(&s->hdr, s->map, kHeaderSize);
  if (memcmp(s->hdr.magic, kMagic, 8) != 0) {
    munmap(s->map, s->map_size);
    close(s->fd);
    delete s;
    return nullptr;
  }
  s->top_bytes = sizeof(int16_t) * s->hdr.top_h * s->hdr.top_w;
  s->bot_bytes = sizeof(int16_t) * s->hdr.bot_h * s->hdr.bot_w;
  s->rec_bytes = record_bytes(s->hdr);
  return s;
}

int64_t cs_count(void* handle) { return static_cast<Store*>(handle)->hdr.count; }

void cs_shape(void* handle, int64_t* out4) {
  auto* s = static_cast<Store*>(handle);
  out4[0] = s->hdr.top_h;
  out4[1] = s->hdr.top_w;
  out4[2] = s->hdr.bot_h;
  out4[3] = s->hdr.bot_w;
}

// Gather a batch of records by index into contiguous output arrays.
// Parallelized: the stage-2 trainer's input pipeline hot path.
int64_t cs_gather(void* handle, const int64_t* indices, int64_t n,
                  int16_t* tops_out, int16_t* bottoms_out, int32_t* labels_out,
                  char* names_out, int64_t n_threads) {
  auto* s = static_cast<Store*>(handle);
  if (!s->map) return -1;
  const int64_t tlen = s->hdr.top_h * s->hdr.top_w;
  const int64_t blen = s->hdr.bot_h * s->hdr.bot_w;

  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const int64_t idx = indices[i];
      if (idx < 0 || idx >= s->hdr.count) continue;
      const uint8_t* rec = s->map + kHeaderSize + idx * s->rec_bytes;
      memcpy(tops_out + i * tlen, rec, s->top_bytes);
      memcpy(bottoms_out + i * blen, rec + s->top_bytes, s->bot_bytes);
      memcpy(labels_out + i, rec + s->top_bytes + s->bot_bytes, sizeof(int32_t));
      if (names_out)
        memcpy(names_out + i * kNameLen,
               rec + s->top_bytes + s->bot_bytes + sizeof(int32_t), kNameLen);
    }
  };

  if (n_threads <= 1 || n < 64) {
    work(0, n);
  } else {
    std::vector<std::thread> threads;
    const int64_t chunk = (n + n_threads - 1) / n_threads;
    for (int64_t t = 0; t < n_threads; ++t) {
      int64_t lo = t * chunk, hi = std::min(n, lo + chunk);
      if (lo >= hi) break;
      threads.emplace_back(work, lo, hi);
    }
    for (auto& th : threads) th.join();
  }
  return n;
}

void cs_close(void* handle) {
  auto* s = static_cast<Store*>(handle);
  if (s->write_fp) fclose(s->write_fp);
  if (s->map) munmap(s->map, s->map_size);
  if (s->fd >= 0) close(s->fd);
  delete s;
}

}  // extern "C"
