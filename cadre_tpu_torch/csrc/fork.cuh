// Shared by the dual-attention kernels: the device's SM count and the
// shared memory a block may opt in to, and launches that run beside the
// caller's. Their side stream (of the default priority, or of the
// greatest) is the calling thread's own for the device, forked from a
// stream by an event after its work so far and joined back by another
// before its next (a fork and join that CUDA graph capture records as
// such), so that the launches' partial last waves and latency-bound phases
// overlap. Made once per host thread, device and priority, at its first
// use: two threads never share an event, so one thread's fork cannot bind
// to another's record.
#pragma once

#include <cuda_runtime.h>

namespace fork2 {

// The current device's SM count (1 if it cannot be read), read once.
inline int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess) {
      count = 1;
    }
  }
  return count;
}

// The most dynamic shared memory a block of the current device may opt in
// to (232,448 bytes on an H100; 48 KB if it cannot be read), read once.
inline size_t smem_optin() {
  static int bytes = 0;
  if (bytes == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev) != cudaSuccess) {
      bytes = 48 * 1024;
    }
  }
  return static_cast<size_t>(bytes);
}

struct Side {
  cudaStream_t stream;
  cudaEvent_t fork, join;
};

// This thread's side stream and events on the current device: of the
// default priority, or with `high` of the device's greatest, whose blocks
// the SMs take before those of a default-priority stream such as the
// caller's.
inline cudaError_t side(Side** out, bool high = false) {
  static thread_local Side sides[2][64];
  static thread_local unsigned long long made[2] = {0, 0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  Side& sd = sides[high][dev & 63];
  if (!(made[high] & bit)) {
    if (high) {
      int least = 0, greatest = 0;
      err = cudaDeviceGetStreamPriorityRange(&least, &greatest);
      if (err == cudaSuccess) {
        err = cudaStreamCreateWithPriority(&sd.stream, cudaStreamNonBlocking,
                                           greatest);
      }
    } else {
      err = cudaStreamCreateWithFlags(&sd.stream, cudaStreamNonBlocking);
    }
    if (err == cudaSuccess) {
      err = cudaEventCreateWithFlags(&sd.fork, cudaEventDisableTiming);
    }
    if (err == cudaSuccess) {
      err = cudaEventCreateWithFlags(&sd.join, cudaEventDisableTiming);
    }
    if (err != cudaSuccess) return err;
    made[high] |= bit;
  }
  *out = &sd;
  return cudaSuccess;
}

// The side stream (`high`: of the greatest priority), which waits for
// everything issued on `st` so far.
inline cudaError_t fork(cudaStream_t st, Side** sd, bool high = false) {
  cudaError_t err = side(sd, high);
  if (err == cudaSuccess) err = cudaEventRecord((*sd)->fork, st);
  if (err == cudaSuccess) err = cudaStreamWaitEvent((*sd)->stream, (*sd)->fork, 0);
  return err;
}

// `st` waits for everything issued on the side stream so far.
inline cudaError_t join(cudaStream_t st, Side* sd) {
  cudaError_t err = cudaEventRecord(sd->join, sd->stream);
  if (err == cudaSuccess) err = cudaStreamWaitEvent(st, sd->join, 0);
  return err;
}

}  // namespace fork2
