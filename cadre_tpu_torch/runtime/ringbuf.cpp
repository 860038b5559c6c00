// Shared-memory frame ring for env-worker -> trainer observation streaming.
//
// The port's copy of the JAX package's ring (the native replacement of the
// reference's torch.multiprocessing shared-memory tensors + mp.Lock
// control plane, ppo_agent/models.py:219-258, utils.py:31-126). Env worker
// processes write fixed-size observation frames into a lock-free ring in
// POSIX shm; the trainer reads them for one batched act. Also used in the
// reverse direction as an action mailbox.
//
// Design: single-producer / single-consumer per ring (one ring per worker
// direction), seqlock-style slot headers with C++11 atomics on the mapped
// region. A writer overwrites the oldest slot when the ring is full
// (latest-wins semantics: observation streams want freshness, and the
// lock-step trainer never lets it happen in practice). Creating a ring
// reserves its pages up front (posix_fallocate), so a full /dev/shm fails
// rb_create with errno ENOSPC instead of a SIGBUS on the first write.
//
// Build: g++ -O2 -std=c++17 -shared -fPIC ringbuf.cpp -o libringbuf.so -lrt
// (driven by cadre_tpu_torch/runtime/native.py; the ctypes bindings are in
// shm_ring.py).

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <time.h>
#include <unistd.h>

namespace {

struct SlotHeader {
  std::atomic<uint64_t> seq;  // 0 = empty; writer sets to frame index + 1
};

struct RingHeader {
  uint32_t magic;
  uint32_t n_slots;
  uint64_t frame_bytes;
  std::atomic<uint64_t> head;  // next frame index to write
  std::atomic<uint64_t> tail;  // next frame index to read
};

constexpr uint32_t kMagic = 0x52494e47;  // "RING"

struct Ring {
  int fd;
  size_t map_bytes;
  RingHeader* hdr;
  SlotHeader* slots;
  uint8_t* data;
  bool owner;
  char name[256];
};

size_t ring_bytes(uint32_t n_slots, uint64_t frame_bytes) {
  return sizeof(RingHeader) + n_slots * sizeof(SlotHeader) +
         n_slots * frame_bytes;
}

void layout(Ring* r, void* base, uint32_t n_slots, uint64_t frame_bytes) {
  r->hdr = reinterpret_cast<RingHeader*>(base);
  r->slots = reinterpret_cast<SlotHeader*>(
      reinterpret_cast<uint8_t*>(base) + sizeof(RingHeader));
  r->data = reinterpret_cast<uint8_t*>(base) + sizeof(RingHeader) +
            n_slots * sizeof(SlotHeader);
}

uint64_t now_ms() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return static_cast<uint64_t>(ts.tv_sec) * 1000 + ts.tv_nsec / 1000000;
}

}  // namespace

extern "C" {

// Create (or recreate) a named ring. Returns handle or null.
void* rb_create(const char* name, uint32_t n_slots, uint64_t frame_bytes) {
  shm_unlink(name);
  int fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return nullptr;
  size_t bytes = ring_bytes(n_slots, frame_bytes);
  if (ftruncate(fd, static_cast<off_t>(bytes)) != 0) {
    int err = errno;
    close(fd);
    shm_unlink(name);
    errno = err;
    return nullptr;
  }
  int err = posix_fallocate(fd, 0, static_cast<off_t>(bytes));
  if (err != 0) {
    close(fd);
    shm_unlink(name);
    errno = err;
    return nullptr;
  }
  void* base = mmap(nullptr, bytes, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  if (base == MAP_FAILED) {
    err = errno;
    close(fd);
    shm_unlink(name);
    errno = err;
    return nullptr;
  }
  Ring* r = new Ring();
  r->fd = fd;
  r->map_bytes = bytes;
  r->owner = true;
  std::strncpy(r->name, name, sizeof(r->name) - 1);
  layout(r, base, n_slots, frame_bytes);
  r->hdr->magic = kMagic;
  r->hdr->n_slots = n_slots;
  r->hdr->frame_bytes = frame_bytes;
  r->hdr->head.store(0);
  r->hdr->tail.store(0);
  for (uint32_t i = 0; i < n_slots; ++i) r->slots[i].seq.store(0);
  return r;
}

// Attach to an existing ring.
void* rb_attach(const char* name) {
  int fd = shm_open(name, O_RDWR, 0600);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return nullptr;
  }
  void* base =
      mmap(nullptr, st.st_size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  if (base == MAP_FAILED) {
    close(fd);
    return nullptr;
  }
  RingHeader* hdr = reinterpret_cast<RingHeader*>(base);
  if (hdr->magic != kMagic) {
    munmap(base, st.st_size);
    close(fd);
    return nullptr;
  }
  Ring* r = new Ring();
  r->fd = fd;
  r->map_bytes = st.st_size;
  r->owner = false;
  std::strncpy(r->name, name, sizeof(r->name) - 1);
  layout(r, base, hdr->n_slots, hdr->frame_bytes);
  return r;
}

uint64_t rb_frame_bytes(void* handle) {
  return static_cast<Ring*>(handle)->hdr->frame_bytes;
}

uint32_t rb_slots(void* handle) {
  return static_cast<Ring*>(handle)->hdr->n_slots;
}

// Number of frames ready to read.
uint64_t rb_available(void* handle) {
  Ring* r = static_cast<Ring*>(handle);
  return r->hdr->head.load(std::memory_order_acquire) -
         r->hdr->tail.load(std::memory_order_relaxed);
}

// Write one frame; overwrites the oldest if full. Returns frame index.
uint64_t rb_write(void* handle, const uint8_t* src, uint64_t len) {
  Ring* r = static_cast<Ring*>(handle);
  uint64_t fb = r->hdr->frame_bytes;
  if (len > fb) len = fb;
  uint64_t idx = r->hdr->head.load(std::memory_order_relaxed);
  uint32_t slot = static_cast<uint32_t>(idx % r->hdr->n_slots);
  r->slots[slot].seq.store(0, std::memory_order_release);  // mark in-flight
  std::memcpy(r->data + static_cast<size_t>(slot) * fb, src, len);
  r->slots[slot].seq.store(idx + 1, std::memory_order_release);
  r->hdr->head.store(idx + 1, std::memory_order_release);
  return idx;
}

// Read the next frame into `dst`; blocks up to timeout_ms.
// Returns frame index, or UINT64_MAX on timeout.
uint64_t rb_read(void* handle, uint8_t* dst, uint64_t timeout_ms) {
  Ring* r = static_cast<Ring*>(handle);
  uint64_t fb = r->hdr->frame_bytes;
  uint64_t deadline = now_ms() + timeout_ms;
  for (;;) {
    uint64_t tail = r->hdr->tail.load(std::memory_order_relaxed);
    uint64_t head = r->hdr->head.load(std::memory_order_acquire);
    if (head > tail) {
      // if the writer lapped us, jump to the oldest intact frame
      if (head - tail > r->hdr->n_slots)
        tail = head - r->hdr->n_slots;
      uint32_t slot = static_cast<uint32_t>(tail % r->hdr->n_slots);
      std::memcpy(dst, r->data + static_cast<size_t>(slot) * fb, fb);
      // validate seq to detect mid-copy overwrite
      uint64_t seq = r->slots[slot].seq.load(std::memory_order_acquire);
      if (seq == tail + 1) {
        r->hdr->tail.store(tail + 1, std::memory_order_release);
        return tail;
      }
      // torn read: advance past the clobbered frame and retry
      r->hdr->tail.store(tail + 1, std::memory_order_release);
      continue;
    }
    if (now_ms() >= deadline) return UINT64_MAX;
    struct timespec ts = {0, 200000};  // 0.2 ms
    nanosleep(&ts, nullptr);
  }
}

// Batch read up to max_frames (waits for at least one until timeout).
// Returns number of frames copied.
uint64_t rb_read_batch(void* handle, uint8_t* dst, uint64_t max_frames,
                       uint64_t timeout_ms) {
  Ring* r = static_cast<Ring*>(handle);
  uint64_t fb = r->hdr->frame_bytes;
  uint64_t got = 0;
  uint64_t first = rb_read(handle, dst, timeout_ms);
  if (first == UINT64_MAX) return 0;
  got = 1;
  while (got < max_frames && rb_available(handle) > 0) {
    if (rb_read(handle, dst + got * fb, 0) == UINT64_MAX) break;
    ++got;
  }
  return got;
}

void rb_close(void* handle) {
  Ring* r = static_cast<Ring*>(handle);
  munmap(r->hdr, r->map_bytes);
  close(r->fd);
  if (r->owner) shm_unlink(r->name);
  delete r;
}

}  // extern "C"
