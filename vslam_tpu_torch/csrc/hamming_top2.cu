// Hamming top-2 kernels for Hopper (sm_90a), plain C interface for ctypes.
//
// These replace the two Pallas kernels of the JAX package:
//
//   hamming_top2_kernel   <- vslam_tpu/ops/pallas_hamming.py::_top2_kernel
//     per row of A: best and second-best Hamming distance over the valid
//     rows of B, and the argmin (lowest index among ties).
//   landmark_top2_kernel  <- vslam_tpu/ops/pallas_hamming.py::_lm_top2_kernel
//     per keypoint: the distance to a landmark is the min over its valid
//     descriptor-bank slots; landmarks outside the 2D gate
//     (dx^2 + dy^2 >= r^2) or invalid do not count. Best, second, argmin,
//     and whether any valid landmark lay inside the gate (independent of
//     bank validity: the JAX package's CPU path, which its tests pin).
//
// Semantics: distances are exact integers; 256 stands for "no candidate"
// (the reference initialises best distances to 256), so a candidate at
// distance 256 never changes the result, exactly as the padded XLA path.
//
// Design. The TPU kernels turn Hamming distance into a +/-1 matmul on the
// MXU and carry the running top-2 in VMEM scratch across a sequential
// column grid axis. Here descriptors arrive packed (32 bytes, the layout of
// describe.pack_bits) and are read as 8 x uint32; a distance is
// sum(__popc(a ^ b)) over the 8 words. One thread owns one query row and
// keeps (best, second, arg) in registers; candidate tiles (bits, validity,
// and for the landmark kernel the projected xy) are staged through shared
// memory and swept in increasing index order with a strict '<' update,
// which gives the lowest-index tie rule. The loop over tiles inside the
// block replaces the TPU's sequential grid axis, so no cross-block
// reduction is needed. The landmark kernel tests the 2D gate before any
// Hamming work, so landmarks outside the radius cost one compare.
//
// What bounds it on an H100: at the main-path shapes (landmarks N=1500
// keypoints x P=2048 landmarks x B=4 bank slots; stereo N=M=1500) the
// inputs are a few hundred KB and stay in L2; the work is integer ALU
// (8 XOR + 8 POPC + adds per pair) and shared-memory broadcast reads.
// One thread per row fills only ceil(1500/128) = 12 blocks on 132 SMs, so
// the kernels are latency- and occupancy-bound, not bandwidth-bound. Right
// first; splitting the candidate axis across blocks (with a second merge
// pass) or int8 +/-1 tensor-core products are the later alternatives.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // query rows per block
constexpr int kTile = 128;     // candidates staged per shared-memory tile
constexpr int kWords = 8;      // 256 bits = 8 x uint32
constexpr int kMaxBank = 8;    // landmark bank slots supported
constexpr int kPad = 256;      // "no candidate" distance

__device__ __forceinline__ int hamming256(const uint32_t (&q)[kWords],
                                          const uint32_t* c) {
  int d = 0;
#pragma unroll
  for (int w = 0; w < kWords; ++w) d += __popc(q[w] ^ c[w]);
  return d;
}

__device__ __forceinline__ void top2_update(int d, int j, int& best,
                                            int& second, int& arg) {
  if (d < best) {
    second = best;
    best = d;
    arg = j;
  } else if (d < second) {
    second = d;
  }
}

__global__ void __launch_bounds__(kThreads)
hamming_top2_kernel(const uint32_t* __restrict__ a,
                    const uint32_t* __restrict__ b,
                    const bool* __restrict__ valid_a,
                    const bool* __restrict__ valid_b, int n, int m,
                    int* __restrict__ best_out, int* __restrict__ second_out,
                    int* __restrict__ arg_out) {
  __shared__ uint32_t s_bits[kTile * kWords];
  __shared__ bool s_valid[kTile];

  const int row = blockIdx.x * kThreads + threadIdx.x;
  const bool active = row < n && valid_a[row];
  uint32_t q[kWords];
#pragma unroll
  for (int w = 0; w < kWords; ++w)
    q[w] = active ? a[static_cast<size_t>(row) * kWords + w] : 0u;

  int best = kPad, second = kPad, arg = 0;
  for (int base = 0; base < m; base += kTile) {
    const int cnt = min(kTile, m - base);
    const uint32_t* tile = b + static_cast<size_t>(base) * kWords;
    for (int i = threadIdx.x; i < cnt * kWords; i += kThreads)
      s_bits[i] = tile[i];
    for (int i = threadIdx.x; i < cnt; i += kThreads)
      s_valid[i] = valid_b[base + i];
    __syncthreads();
    if (active) {
      for (int j = 0; j < cnt; ++j) {
        if (!s_valid[j]) continue;
        top2_update(hamming256(q, s_bits + j * kWords), base + j, best,
                    second, arg);
      }
    }
    __syncthreads();
  }
  if (row < n) {
    best_out[row] = best;
    second_out[row] = second;
    arg_out[row] = arg;
  }
}

__global__ void __launch_bounds__(kThreads)
landmark_top2_kernel(const uint32_t* __restrict__ kp,
                     const bool* __restrict__ kp_valid,
                     const float* __restrict__ kp_xy,
                     const uint32_t* __restrict__ bank,
                     const bool* __restrict__ bank_valid,
                     const float* __restrict__ lm_xy,
                     const bool* __restrict__ lm_valid, float r2, int n,
                     int p, int nb, int* __restrict__ best_out,
                     int* __restrict__ second_out, int* __restrict__ arg_out,
                     bool* __restrict__ any_out) {
  __shared__ uint32_t s_bits[kTile * kMaxBank * kWords];
  __shared__ float s_xy[kTile * 2];
  __shared__ bool s_bank_valid[kTile * kMaxBank];
  __shared__ bool s_lm_valid[kTile];

  const int row = blockIdx.x * kThreads + threadIdx.x;
  const bool active = row < n && kp_valid[row];
  uint32_t q[kWords];
#pragma unroll
  for (int w = 0; w < kWords; ++w)
    q[w] = active ? kp[static_cast<size_t>(row) * kWords + w] : 0u;
  const float kx = active ? kp_xy[2 * row] : 0.f;
  const float ky = active ? kp_xy[2 * row + 1] : 0.f;

  int best = kPad, second = kPad, arg = 0;
  bool any = false;
  for (int base = 0; base < p; base += kTile) {
    const int cnt = min(kTile, p - base);
    const uint32_t* tile = bank + static_cast<size_t>(base) * nb * kWords;
    for (int i = threadIdx.x; i < cnt * nb * kWords; i += kThreads)
      s_bits[i] = tile[i];
    for (int i = threadIdx.x; i < cnt * nb; i += kThreads)
      s_bank_valid[i] = bank_valid[static_cast<size_t>(base) * nb + i];
    for (int i = threadIdx.x; i < cnt; i += kThreads) {
      s_lm_valid[i] = lm_valid[base + i];
      s_xy[2 * i] = lm_xy[2 * (base + i)];
      s_xy[2 * i + 1] = lm_xy[2 * (base + i) + 1];
    }
    __syncthreads();
    if (active) {
      for (int j = 0; j < cnt; ++j) {
        if (!s_lm_valid[j]) continue;
        // the gate in the plain version's rounding: no fused multiply-add
        const float dx = __fsub_rn(kx, s_xy[2 * j]);
        const float dy = __fsub_rn(ky, s_xy[2 * j + 1]);
        const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
        if (!(d2 < r2)) continue;
        any = true;
        int dmin = kPad;
        for (int s = 0; s < nb; ++s) {
          if (s_bank_valid[j * nb + s])
            dmin = min(dmin, hamming256(q, s_bits + (j * nb + s) * kWords));
        }
        top2_update(dmin, base + j, best, second, arg);
      }
    }
    __syncthreads();
  }
  if (row < n) {
    best_out[row] = best;
    second_out[row] = second;
    arg_out[row] = arg;
    any_out[row] = any;
  }
}

}  // namespace

extern "C" {

// Each entry point launches on the given stream and returns
// cudaGetLastError() (0 = launched). Inputs are device pointers; the
// Python wrapper checks shapes, types and contiguity.

int vslam_hamming_top2(const void* a, const void* b, const void* valid_a,
                       const void* valid_b, int n, int m, void* best,
                       void* second, void* arg, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((n + kThreads - 1) / kThreads);
  hamming_top2_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<const bool*>(valid_a), static_cast<const bool*>(valid_b),
      n, m, static_cast<int*>(best), static_cast<int*>(second),
      static_cast<int*>(arg));
  return static_cast<int>(cudaGetLastError());
}

int vslam_landmark_top2(const void* kp, const void* kp_valid,
                        const void* kp_xy, const void* bank,
                        const void* bank_valid, const void* lm_xy,
                        const void* lm_valid, float r2, int n, int p, int nb,
                        void* best, void* second, void* arg, void* any,
                        void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (nb < 0 || nb > kMaxBank)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kThreads - 1) / kThreads);
  landmark_top2_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(kp), static_cast<const bool*>(kp_valid),
      static_cast<const float*>(kp_xy), static_cast<const uint32_t*>(bank),
      static_cast<const bool*>(bank_valid),
      static_cast<const float*>(lm_xy), static_cast<const bool*>(lm_valid),
      r2, n, p, nb, static_cast<int*>(best), static_cast<int*>(second),
      static_cast<int*>(arg), static_cast<bool*>(any));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
