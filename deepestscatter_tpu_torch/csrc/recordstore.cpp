// recordstore — a native, mmap-backed typed record store.
//
// This package's own copy of deepestscatter_tpu/native/recordstore.cpp,
// with the same file layout, so that tables written by either package read
// back through the other.  data/store.py builds it with g++ at first use
// into the package's _build/ directory.
//
// Capability parity with the reference's LMDB wrapper
// (DG/src/Util/Dataset/Dataset.{h,cpp}, Transaction.{h,cpp}): a typed
// key-value store with one table per record type, int32 keys, atomic batch
// append, count-based resume, and on-demand growth.  Design differences,
// chosen for a tensor pipeline:
//
//  - Records are fixed-size (the schemas in data/records.py are fixed-size
//    structs), so a table is a flat mmap'd array: O(1) reads become pointer
//    arithmetic and whole batches map zero-copy into numpy — the Python
//    data loader feeds whole batches without deserialization.
//  - "Transaction" semantics: batch appends write record payloads first,
//    then publish by updating the header count with a release store +
//    msync, so readers never observe partially written batches (the role
//    of LMDB's write transactions in Dataset.h:203-232).
//  - Map-full handling: the file grows by doubling, like the reference's
//    MDB_MAP_FULL handler (Dataset.cpp:38-66).
//
// Layout per table file:
//   [Header: magic, version, record_size, count, capacity]
//   [capacity * record_size bytes of records]
//
// Exposed as a C ABI consumed via ctypes (data/store.py).

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <string>

#include <fcntl.h>
#include <sys/file.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x44535452454331ULL;  // "DSTREC1"
constexpr uint64_t kVersion = 1;

struct Header {
  uint64_t magic;
  uint64_t version;
  uint64_t record_size;
  std::atomic<uint64_t> count;  // published record count (contiguous from 0)
  uint64_t capacity;            // allocated record slots
  uint64_t reserved[3];
};
static_assert(sizeof(Header) == 64, "header must stay 64 bytes");

struct Table {
  int fd = -1;
  void* map = MAP_FAILED;
  size_t map_size = 0;
  std::string path;

  Header* header() { return static_cast<Header*>(map); }
  uint8_t* records() { return static_cast<uint8_t*>(map) + sizeof(Header); }
};

int remap(Table* t, uint64_t capacity) {
  const size_t new_size = sizeof(Header) + capacity * t->header()->record_size;
  Header* old_header = t->header();
  if (new_size <= t->map_size) {
    old_header->capacity = capacity;
    return 0;
  }
  if (ftruncate(t->fd, static_cast<off_t>(new_size)) != 0) return -errno;
  void* fresh = mremap(t->map, t->map_size, new_size, MREMAP_MAYMOVE);
  if (fresh == MAP_FAILED) return -errno;
  t->map = fresh;
  t->map_size = new_size;
  t->header()->capacity = capacity;
  return 0;
}

}  // namespace

extern "C" {

// Opens (creating if needed) a table file for records of `record_size`
// bytes.  Returns an opaque handle or null on failure.
void* rs_open(const char* path, uint64_t record_size) {
  Table* t = new Table();
  t->path = path;
  t->fd = open(path, O_RDWR | O_CREAT, 0644);
  if (t->fd < 0) {
    delete t;
    return nullptr;
  }
  struct stat st;
  if (fstat(t->fd, &st) != 0) {
    close(t->fd);
    delete t;
    return nullptr;
  }
  const uint64_t initial_capacity = 4096;
  if (st.st_size == 0) {
    const size_t size = sizeof(Header) + initial_capacity * record_size;
    if (ftruncate(t->fd, static_cast<off_t>(size)) != 0) {
      close(t->fd);
      delete t;
      return nullptr;
    }
    t->map_size = size;
    t->map = mmap(nullptr, size, PROT_READ | PROT_WRITE, MAP_SHARED, t->fd, 0);
    if (t->map == MAP_FAILED) {
      close(t->fd);
      delete t;
      return nullptr;
    }
    Header* h = t->header();
    h->magic = kMagic;
    h->version = kVersion;
    h->record_size = record_size;
    h->count.store(0, std::memory_order_release);
    h->capacity = initial_capacity;
  } else {
    t->map_size = static_cast<size_t>(st.st_size);
    t->map = mmap(nullptr, t->map_size, PROT_READ | PROT_WRITE, MAP_SHARED, t->fd, 0);
    if (t->map == MAP_FAILED) {
      close(t->fd);
      delete t;
      return nullptr;
    }
    Header* h = t->header();
    if (h->magic != kMagic || h->version != kVersion ||
        h->record_size != record_size) {
      munmap(t->map, t->map_size);
      close(t->fd);
      delete t;
      return nullptr;
    }
  }
  return t;
}

uint64_t rs_count(void* handle) {
  Table* t = static_cast<Table*>(handle);
  return t->header()->count.load(std::memory_order_acquire);
}

uint64_t rs_record_size(void* handle) {
  return static_cast<Table*>(handle)->header()->record_size;
}

// Atomically append `n` records starting at id `start`.  Appends must be
// contiguous with the published count (the reference resumes from
// count/batch_size, Tasks.h:59-68); out-of-order writes beyond count are
// allowed (disjoint shard ranges) but only contiguous data is published.
// Returns 0 on success, negative errno on failure.
int rs_write(void* handle, uint64_t start, const void* data, uint64_t n) {
  Table* t = static_cast<Table*>(handle);
  if (flock(t->fd, LOCK_EX) != 0) return -errno;
  Header* h = t->header();
  const uint64_t rs = h->record_size;
  uint64_t needed = start + n;
  if (needed > h->capacity) {
    uint64_t cap = h->capacity;
    while (cap < needed) cap *= 2;  // map-full → double (Dataset.cpp:38-66)
    int err = remap(t, cap);
    if (err != 0) {
      flock(t->fd, LOCK_UN);
      return err;
    }
    h = t->header();
  }
  std::memcpy(t->records() + start * rs, data, n * rs);
  // Publish: data before count (release), then flush both ranges.
  msync(t->records() + start * rs, n * rs, MS_SYNC);
  uint64_t cur = h->count.load(std::memory_order_relaxed);
  if (start <= cur && start + n > cur) {
    h->count.store(start + n, std::memory_order_release);
    msync(t->map, sizeof(Header), MS_SYNC);
  }
  flock(t->fd, LOCK_UN);
  return 0;
}

// Read `n` records starting at `start` into `out`.  Returns the number of
// records actually read (clamped to the published count).
uint64_t rs_read(void* handle, uint64_t start, void* out, uint64_t n) {
  Table* t = static_cast<Table*>(handle);
  Header* h = t->header();
  const uint64_t count = h->count.load(std::memory_order_acquire);
  if (start >= count) return 0;
  const uint64_t take = (start + n <= count) ? n : count - start;
  std::memcpy(out, t->records() + start * h->record_size,
              take * h->record_size);
  return take;
}

// Point-gather `n` records by id into `out` (the shuffled-batch read path:
// a random training batch must cost O(batch) records, not a covering-range
// read that approaches O(table) as the table grows).  All ids must be below
// the published count.  Returns 0 on success, -EINVAL on any out-of-range
// id (nothing is partially defined in `out` that the caller may trust).
int rs_gather(void* handle, const uint64_t* ids, void* out, uint64_t n) {
  Table* t = static_cast<Table*>(handle);
  Header* h = t->header();
  const uint64_t count = h->count.load(std::memory_order_acquire);
  const uint64_t rs = h->record_size;
  const uint8_t* base = t->records();
  uint8_t* dst = static_cast<uint8_t*>(out);
  for (uint64_t i = 0; i < n; ++i) {
    if (ids[i] >= count) return -EINVAL;
    std::memcpy(dst + i * rs, base + ids[i] * rs, rs);
  }
  return 0;
}

// Drop all records (the reference demands interactive confirmation,
// Dataset.h:110-142 — enforced at the Python layer here).
int rs_drop(void* handle) {
  Table* t = static_cast<Table*>(handle);
  if (flock(t->fd, LOCK_EX) != 0) return -errno;
  t->header()->count.store(0, std::memory_order_release);
  msync(t->map, sizeof(Header), MS_SYNC);
  flock(t->fd, LOCK_UN);
  return 0;
}

void rs_close(void* handle) {
  Table* t = static_cast<Table*>(handle);
  if (t->map != MAP_FAILED) munmap(t->map, t->map_size);
  if (t->fd >= 0) close(t->fd);
  delete t;
}

}  // extern "C"
