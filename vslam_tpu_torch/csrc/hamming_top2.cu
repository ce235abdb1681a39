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
// Invalid rows, and rows without a candidate, give (256, 256, 0).
//
// The TPU kernels turn Hamming distance into a +/-1 matmul on the MXU and
// carry the running top-2 in VMEM scratch across a sequential column grid
// axis. Here blocks run in parallel, so each design says where the
// candidate axis goes.
//
// landmark_top2_kernel. Descriptors arrive packed (32 bytes, the layout of
// describe.pack_bits) and are read as 8 x uint32; a distance is
// sum(__popc(a ^ b)) over the 8 words. One thread owns one query row and
// keeps (best, second, arg) in registers; candidate tiles (bits, validity,
// projected xy) are staged through shared memory and swept in increasing
// index order with a strict '<' update, which gives the lowest-index tie
// rule. The 2D gate is tested before any Hamming work, so landmarks
// outside the radius cost one compare. At N=1500 keypoints x P=2048
// landmarks x B=4 slots the inputs stay in L2 and one thread per row
// fills ceil(1500/128) = 12 blocks on 132 SMs: latency- and
// occupancy-bound, but the gate skips most of the work.
//
// hamming_top2_kernel. No gate skips anything, so the candidate axis is
// spread over the card and the distances come from the tensor cores.
//   - Grid: one block per 16 query rows, ceil(N/16) blocks (94 at N=1500,
//     against 12 for one thread per row). The block's 16 warps take
//     interleaved 16-candidate chunks of B (two mma tiles each); no thread
//     runs a serial chain over all M candidates.
//   - Distances: mma.sync m16n8k256 .b1 with .and.popc gives popc(a & b)
//     for a 16 x 8 tile over all 256 bits in one instruction, and
//     h = popc(a) + popc(b) - 2 popc(a & b), with the popcounts taken once
//     per staged row. Fragments as CuTe's traits for
//     SM80_16x8x256_S32U1U1S32_TN_ANDPOPC lay them out (g = lane / 4,
//     t = lane % 4): A rows g and g+8, words t and t+4; B candidate g,
//     words t and t+4; C rows g and g+8, candidates 2t and 2t+1. Hopper's
//     wgmma offers only AND for b1 too, but takes 64-row tiles: 24 blocks
//     at N=1500, an idle card again.
//   - Loads: each warp stages its next chunk of {0,1} descriptor bytes
//     (what the main path holds) into shared memory with cp.async while
//     it computes the current one (double-buffered), and packs each
//     16-byte piece to 16 bits in the load stage (byte i -> bit i, the
//     layout of describe.pack_bits), so no separate packing pass runs.
//   - Exact merge: the running best is the key (d << 23) | j, so a min
//     gives the lowest index among equal distances in whatever order
//     partial results meet; the second-best is the multiset one,
//     min(sP, sQ, max(bP, bQ)). Lanes of a quad merge by shuffles, warps
//     through shared memory: no atomics, no second pass, deterministic.
//     An invalid or padding candidate gets popcount 512, so its distance
//     clamps to 256 and changes nothing; the initial key (256, 0) keeps
//     arg 0 whenever best is 256. M is limited to 2^23 by the key.
//   What bounds it: at N=M=1500 the products are ~18 k mma instructions,
//   nothing for the card, and every block reads all of B (384 KB of
//   bytes) from L2. On an H100 80GB HBM3 at 700 W it takes ~13 us;
//   exploratory timing-only mutants took 10.3 us without any B traffic
//   and 11.5 us without the packing work. So it is bound by the latency
//   of each warp's ~6 dependent rounds (stage, wait, pack, popcount, mma,
//   merge) and by the launch, not by L2 bandwidth or ALU; more warps per
//   block mean fewer rounds (17.1 us at 8 warps of 32-candidate chunks),
//   up to what shared memory holds (~158 KB per block: one block per SM).
//   Packing both sides with describe.pack_bits instead took 31.7 us.

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

// ---- hamming_top2_kernel ------------------------------------------------

constexpr int kRows = 16;     // query rows per block: the mma's M
constexpr int kWarps = 16;    // warps per block; they split the candidates
constexpr int kChunk = 16;    // candidates per warp step: 2 mma tiles of 8
constexpr int kStride = 12;   // words per packed row in shared memory (not
                              // 8: conflict-free fragment reads)
constexpr int kArgBits = 23;  // key = distance << 23 | candidate index
constexpr uint32_t kArgMask = (1u << kArgBits) - 1;
constexpr uint32_t kNoKey = static_cast<uint32_t>(kPad) << kArgBits;
constexpr int kBadPop = 512;  // popcount of an invalid candidate: h >= 256
constexpr int kThreadsTop2 = kWarps * 32;
static_assert(kChunk % 16 == 0 && kChunk <= 32, "a row per lane");

struct Top2Smem {
  alignas(16) uint32_t a[kRows][kStride];
  alignas(16) uint32_t packed[kWarps][2][kChunk][kStride];
  int pa[kRows];
  alignas(8) int pb[kWarps][2][kChunk];
  uint32_t part_key[kWarps][kRows];
  int part_second[kWarps][kRows];
  alignas(16) uint8_t raw[kWarps][2][kChunk][256];  // the bytes as staged
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// 16 {0,1} bytes -> 16 bits, byte i -> bit i.
__device__ __forceinline__ uint32_t pack16(uint4 v) {
  constexpr uint64_t kOnes = 0x0101010101010101ull;
  constexpr uint64_t kGather = 0x0102040810204080ull;
  const uint64_t lo = ((static_cast<uint64_t>(v.y) << 32) | v.x) & kOnes;
  const uint64_t hi = ((static_cast<uint64_t>(v.w) << 32) | v.z) & kOnes;
  return static_cast<uint32_t>((lo * kGather) >> 56) |
         (static_cast<uint32_t>((hi * kGather) >> 56) << 8);
}

// d[i] = popc(A & B) of the 16 x 8 tile, C layout: d0 (g, 2t), d1 (g,
// 2t+1), d2 (g+8, 2t), d3 (g+8, 2t+1).
__device__ __forceinline__ void mma_and_popc(const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1,
                                             int (&d)[4]) {
  asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %11, %12, %13};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "r"(0), "r"(0), "r"(0), "r"(0));
}

// Merge a partial (key, second) into (best, second): order-free.
__device__ __forceinline__ void top2_merge(uint32_t& best, int& second,
                                           uint32_t key, int other_second) {
  second = min(min(second, other_second),
               static_cast<int>(max(best, key) >> kArgBits));
  best = min(best, key);
}

__device__ __forceinline__ void top2_add(int h, uint32_t j, uint32_t& best,
                                         int& second) {
  top2_merge(best, second,
             (static_cast<uint32_t>(min(h, kPad)) << kArgBits) | j, kPad);
}

// Starts the copy of candidate rows [base, base + kChunk) into dst; rows
// past m are zero-filled.
__device__ __forceinline__ void stage_chunk(const uint8_t* __restrict__ b,
                                            int m, int base, uint8_t* dst,
                                            int lane) {
  constexpr int kPieces = 256 / 16;
#pragma unroll
  for (int k = 0; k < kChunk * kPieces / 32; ++k) {
    const int p = k * 32 + lane;
    const int r = p / kPieces, q = p % kPieces;
    const int j = base + r;
    cp_async16(dst + r * 256 + q * 16,
               b + static_cast<size_t>(j < m ? j : 0) * 256 + q * 16, j < m);
  }
}

// a [N, 256], b [M, 256]: descriptors as {0,1} bytes, 16-byte aligned.
__global__ void __launch_bounds__(kThreadsTop2)
hamming_top2_kernel(const uint8_t* __restrict__ a,
                    const uint8_t* __restrict__ b,
                    const bool* __restrict__ valid_a,
                    const bool* __restrict__ valid_b, int n, int m,
                    int* __restrict__ best_out, int* __restrict__ second_out,
                    int* __restrict__ arg_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  auto& s = *reinterpret_cast<Top2Smem*>(smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * kRows;

  // Stages chunk c into buffer buf (nothing past m; the group is committed
  // either way) and returns the validity of this lane's candidate in it.
  auto stage = [&](int c, int buf) {
    const int base = c * kChunk;
    bool valid = false;
    if (base < m) {
      stage_chunk(b, m, base, &s.raw[warp][buf][0][0], lane);
      valid = lane < kChunk && base + lane < m && valid_b[base + lane];
    }
    cp_async_commit();
    return valid;
  };
  bool valid_cur = stage(warp, 0);  // lands while A is read

  // A: this block's 16 rows, packed, and their popcounts; one thread per
  // 16-byte piece (whole warps, for the shuffle).
  for (int p = tid; p < kRows * 16; p += kThreadsTop2) {
    const int r = p >> 4, q = p & 15;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n)
      v = __ldg(reinterpret_cast<const uint4*>(
                    a + static_cast<size_t>(row0 + r) * 256) + q);
    const uint32_t h = pack16(v);
    const uint32_t h_next = __shfl_down_sync(0xffffffffu, h, 1);
    if (!(q & 1)) s.a[r][q >> 1] = h | (h_next << 16);
  }
  __syncthreads();
  if (tid < kRows) {
    int pop = 0;
#pragma unroll
    for (int w = 0; w < kWords; ++w) pop += __popc(s.a[tid][w]);
    s.pa[tid] = pop;
  }
  __syncthreads();
  const uint32_t afrag[4] = {s.a[g][t], s.a[g + 8][t], s.a[g][t + 4],
                             s.a[g + 8][t + 4]};
  const int pa0 = s.pa[g], pa1 = s.pa[g + 8];

  uint32_t best0 = kNoKey, best1 = kNoKey;  // rows g and g + 8
  int second0 = kPad, second1 = kPad;
  int buf = 0;
  for (int c = warp; c * kChunk < m; c += kWarps, buf ^= 1) {
    const bool valid_next = stage(c + kWarps, buf ^ 1);
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // chunk c
    __syncwarp();
    uint32_t* pk = &s.packed[warp][buf][0][0];
    const uint8_t* raw = &s.raw[warp][buf][0][0];
    // lanes 0-15 pack row r, lanes 16-31 row r + 1, 16 bytes each
#pragma unroll 4
    for (int r = 0; r < kChunk; r += 2) {
      const int row = r + (lane >> 4), q = lane & 15;
      const uint32_t h =
          pack16(*reinterpret_cast<const uint4*>(raw + row * 256 + q * 16));
      const uint32_t h_next = __shfl_down_sync(0xffffffffu, h, 1);
      if (!(q & 1)) pk[row * kStride + (q >> 1)] = h | (h_next << 16);
    }
    __syncwarp();
    if (lane < kChunk) {  // lane l: popcount of candidate row l
      const uint4* w = reinterpret_cast<const uint4*>(pk + lane * kStride);
      const uint4 w0 = w[0], w1 = w[1];
      const int pop = __popc(w0.x) + __popc(w0.y) + __popc(w0.z) +
                      __popc(w0.w) + __popc(w1.x) + __popc(w1.y) +
                      __popc(w1.z) + __popc(w1.w);
      s.pb[warp][buf][lane] = valid_cur ? pop : kBadPop;
    }
    __syncwarp();
    const uint32_t base = static_cast<uint32_t>(c * kChunk);
#pragma unroll
    for (int i = 0; i < kChunk / 8; ++i) {
      const uint32_t* col = pk + (8 * i + g) * kStride;
      int d[4];
      mma_and_popc(afrag, col[t], col[t + 4], d);
      const int2 pb =
          *reinterpret_cast<const int2*>(&s.pb[warp][buf][8 * i + 2 * t]);
      const uint32_t j = base + 8 * i + 2 * t;
      top2_add(pa0 + pb.x - 2 * d[0], j, best0, second0);
      top2_add(pa0 + pb.y - 2 * d[1], j + 1, best0, second0);
      top2_add(pa1 + pb.x - 2 * d[2], j, best1, second1);
      top2_add(pa1 + pb.y - 2 * d[3], j + 1, best1, second1);
    }
    valid_cur = valid_next;
    __syncwarp();  // buf is refilled two steps on
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");

  // the quad's lanes hold the same rows over different candidates
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    top2_merge(best0, second0, __shfl_xor_sync(0xffffffffu, best0, off),
               __shfl_xor_sync(0xffffffffu, second0, off));
    top2_merge(best1, second1, __shfl_xor_sync(0xffffffffu, best1, off),
               __shfl_xor_sync(0xffffffffu, second1, off));
  }
  if (t == 0) {
    s.part_key[warp][g] = best0;
    s.part_second[warp][g] = second0;
    s.part_key[warp][g + 8] = best1;
    s.part_second[warp][g + 8] = second1;
  }
  __syncthreads();
  const int row = row0 + tid;
  if (tid < kRows && row < n) {
    uint32_t best = kNoKey;
    int second = kPad;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      top2_merge(best, second, s.part_key[w][tid], s.part_second[w][tid]);
    const bool ok = valid_a[row];
    best_out[row] = ok ? static_cast<int>(best >> kArgBits) : kPad;
    second_out[row] = ok ? second : kPad;
    arg_out[row] = ok ? static_cast<int>(best & kArgMask) : 0;
  }
}

constexpr int kMaxDevices = 64;

// Allows hamming_top2_kernel its shared memory on the current device, once
// per device (concurrent first calls may both set it; that is harmless).
cudaError_t allow_top2_smem() {
  static bool allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && allowed[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(hamming_top2_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             sizeof(Top2Smem));
  if (err == cudaSuccess && dev < kMaxDevices) allowed[dev] = true;
  return err;
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
  if (m < 0 || m > static_cast<int>(kArgMask) + 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_top2_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  hamming_top2_kernel<<<(n + kRows - 1) / kRows, kThreadsTop2,
                        sizeof(Top2Smem),
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(b),
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
