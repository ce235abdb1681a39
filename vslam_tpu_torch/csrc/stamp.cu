// Stage stamps for the streaming driver's per-frame spans (sm_90a), plain C
// interface for ctypes. Built into the same library as hamming_top2.cu.
//
// A stamp is a one-thread kernel that writes the device's nanosecond timer
// (%globaltimer) into slot [frame mod rows, col] of a ring of int64 slots;
// a count writes a device int32 (or a constant) there instead. The frame
// index is read on the device from the driver's frame counter, so a stamp
// captured into a CUDA graph is an ordinary kernel node that needs no host
// read and no launch of its own at replay. The ring is pinned host memory
// that the device maps: the writes cross the bus, and the host reads them
// once the stream has passed them. With a null frame pointer the slot is
// [0, col] (the host's clock calibration).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ int64_t* slot(const int* frame, int64_t* ring,
                                         int rows, int cols, int col) {
  const int row = frame == nullptr ? 0 : *frame % rows;
  return ring + static_cast<int64_t>(row) * cols + col;
}

__global__ void stamp_kernel(const int* frame, int64_t* ring, int rows,
                             int cols, int col) {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  *slot(frame, ring, rows, cols, col) = static_cast<int64_t>(t);
}

__global__ void count_kernel(const int* frame, const int* value,
                             int64_t constant, int64_t* ring, int rows,
                             int cols, int col) {
  *slot(frame, ring, rows, cols, col) =
      value == nullptr ? constant : static_cast<int64_t>(*value);
}

}  // namespace

extern "C" {

// Each launcher makes one launch on the given stream and returns
// cudaGetLastError() (0 = launched). ``ring`` is a device pointer
// (vslam_mapped_pointer of the pinned host ring).

int vslam_stamp(const void* frame, void* ring, int rows, int cols, int col,
                void* stream) {
  stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(frame), static_cast<int64_t*>(ring), rows,
      cols, col);
  return static_cast<int>(cudaGetLastError());
}

int vslam_count(const void* frame, const void* value, long long constant,
                void* ring, int rows, int cols, int col, void* stream) {
  count_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(frame), static_cast<const int*>(value),
      static_cast<int64_t>(constant), static_cast<int64_t*>(ring), rows, cols,
      col);
  return static_cast<int>(cudaGetLastError());
}

// The device address of pinned host memory (cudaHostGetDevicePointer).
int vslam_mapped_pointer(void* host, void** device) {
  return static_cast<int>(cudaHostGetDevicePointer(device, host, 0));
}

}  // extern "C"
