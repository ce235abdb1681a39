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
// landmark_top2_kernel. The 2D gate (20 px on a 752 x 480 image at the
// main path's settings) rules out ~99.7% of the N x P pairs before any
// Hamming work, so the design gates first and spends the card on the few
// pairs left.
//   - Grid: one warp per keypoint row, 16 rows per block: 1500 warps in
//     94 blocks at N=1500; gridDim.y is the sequence axis of the
//     multi-sequence path (S stacked problems in one launch, 752 blocks
//     at S=8; the single-sequence callers are S=1 of the same kernel).
//     With 120 registers a thread (the next batch's bank bytes are held
//     while this one is summed) one such block fits an SM; more, smaller
//     blocks or several warps per row ran slower.
//   - Staging: the block stages the landmarks' xy in shared memory, 2048
//     at a time (16 KB), every load made before any store; an invalid
//     landmark, or padding to a whole gate round, is NaN, so the one
//     compare also tests validity.
//   - Gate: lane l tests landmark 32 k + l at step k, eight steps at a
//     time with no branch and no vote, in the plain version's rounding
//     (__fmul_rn / __fadd_rn: no fused multiply-add), into bit k of its
//     own 64-bit mask; an OR across the warp then gives the steps with a
//     hit, and a ballot per such step its hits.
//   - Hamming work only for hits, four at a time, in increasing index:
//     each group of 8 lanes takes one hit, and lane l reads bytes
//     32 (l % 8) .. +32 of each of its bank slots (two 16-byte __ldg per
//     slot). The distance needs no packing: the XOR of two words of {0,1}
//     bytes has its differences in bit 0 of each byte, so eight XORs
//     shifted by 0..7 add up without carries to one word for __popc.
//     Shuffles sum each slot over the group's lanes (two slots per 32-bit
//     sum), an invalid slot counts 256, the min over slots is the
//     distance. The next batch's bank bytes are loaded before this batch
//     is summed, so their L2 round trip overlaps its work.
//   - Exact merge in any order: each group keeps its own top-2 on the
//     key (d << 23) | j, as hamming_top2_kernel does, so the lowest index
//     wins ties and the second-best is the multiset one; the four groups
//     merge by shuffles at the end. any_candidate is "some hit", whatever
//     the bank validity. P is limited to 2^23 by the key.
//   The kernel takes the {0,1} descriptor bytes the main path holds: one
//   launch per call, no packing pass.
//   What bounds it: the main path hands it 2,540,776 bytes (keypoint and
//   bank bytes, validities, xy, outputs), ~0.76 us at 3.35 TB/s, fewer
//   where banks are empty or no keypoint gates a landmark, and ~10 k
//   gated pairs. In practice the launch and three phases in a row bound
//   it: the staging round trip and barrier, the N x P gate tests at the
//   instruction rate, and the hits of the rows that have the most (~20,
//   ~7 on average at the main path's density), one L2 round trip per
//   batch of four.
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

constexpr int kWords = 8;      // 256 bits = 8 x uint32
constexpr int kMaxBank = 8;    // landmark bank slots supported
constexpr int kPad = 256;      // "no candidate" distance
constexpr unsigned kFull = 0xffffffffu;

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

// ---- landmark_top2_kernel -----------------------------------------------

constexpr int kLmWarps = 16;      // keypoint rows per block, one per warp
constexpr int kLmThreads = kLmWarps * 32;
constexpr int kLmChunk = 2048;    // landmarks staged per chunk (16 KB)
constexpr int kUnroll = 8;        // gate steps a warp takes at once
constexpr int kLmPad = 32 * kUnroll;  // staged multiple: whole rounds
constexpr int kHitLanes = 8;      // lanes per hit: 32 bytes of a slot each
constexpr int kBatch = 32 / kHitLanes;  // hits a warp takes at once
constexpr int kSlotsPerPass = 4;  // bank slots loaded at once
constexpr int kMaxSequences = 65535;  // gridDim.y's limit
static_assert(kLmChunk / 32 <= 64, "a lane keeps its gate bits in 64 bits");
static_assert(kLmChunk % kLmPad == 0, "whole rounds per chunk");
static_assert(kSlotsPerPass == 4, "pass_min sums slots in pairs");

// Bytes 32 sub .. 32 sub + 31 of a 16-byte aligned {0,1} descriptor row.
struct Bytes32 {
  uint4 lo, hi;
};

__device__ __forceinline__ Bytes32 load32(const uint8_t* row, int sub) {
  const uint4* src = reinterpret_cast<const uint4*>(row) + 2 * sub;
  return {__ldg(src), __ldg(src + 1)};
}

// The number of differing bytes between two runs of 32 {0,1} bytes: the
// XOR of each 32-bit word has its differences in bit 0 of its bytes, so
// word i is shifted by i and the eight are added (no carries: each bit
// position gets one word) before a single popcount.
__device__ __forceinline__ int byte_distance(const Bytes32& a,
                                             const Bytes32& b) {
  const uint32_t d = (a.lo.x ^ b.lo.x) + ((a.lo.y ^ b.lo.y) << 1) +
                     ((a.lo.z ^ b.lo.z) << 2) + ((a.lo.w ^ b.lo.w) << 3) +
                     ((a.hi.x ^ b.hi.x) << 4) + ((a.hi.y ^ b.hi.y) << 5) +
                     ((a.hi.z ^ b.hi.z) << 6) + ((a.hi.w ^ b.hi.w) << 7);
  return __popc(d);
}

// Four slots (s0 .. s0 + 3) of landmark j's bank as one lane of a hit's
// group reads them: bytes 32 sub .. +31 of each, and their validity. A
// slot past nb reloads slot 0 and counts as invalid.
struct BankPass {
  Bytes32 v[kSlotsPerPass];
  bool ok[kSlotsPerPass];
};

__device__ __forceinline__ BankPass load_pass(
    const uint8_t* __restrict__ bank, const bool* __restrict__ bank_valid,
    int j, int nb, int s0, int sub) {
  BankPass b;
  const size_t first = static_cast<size_t>(j) * nb;
#pragma unroll
  for (int s = 0; s < kSlotsPerPass; ++s) {
    const bool in = s0 + s < nb;
    const size_t slot = first + (in ? s0 + s : 0);
    b.v[s] = load32(bank + slot * 256, sub);
    b.ok[s] = in && bank_valid[slot];
  }
  return b;
}

// min(dmin, the distance from the keypoint (bytes 32 sub .. +31 of it in
// kb) to each valid slot of the pass), summed over the group's 8 lanes
// (lanes 8g .. 8g + 7), which all get the result; the whole warp calls it.
__device__ __forceinline__ int pass_min(const BankPass& b, const Bytes32& kb,
                                        int dmin) {
  // two slots per 32-bit sum (16 bits each)
  int h01 = byte_distance(kb, b.v[0]) | (byte_distance(kb, b.v[1]) << 16);
  int h23 = byte_distance(kb, b.v[2]) | (byte_distance(kb, b.v[3]) << 16);
#pragma unroll
  for (int off = 1; off < kHitLanes; off <<= 1) {
    h01 += __shfl_xor_sync(kFull, h01, off);
    h23 += __shfl_xor_sync(kFull, h23, off);
  }
  const int h[kSlotsPerPass] = {h01 & 0xffff, h01 >> 16, h23 & 0xffff,
                                h23 >> 16};
#pragma unroll
  for (int s = 0; s < kSlotsPerPass; ++s)
    if (b.ok[s]) dmin = min(dmin, h[s]);
  return dmin;
}

// kp [S, N, 256], bank [S, P, B, 256]: descriptors as {0,1} bytes, 16-byte
// aligned; kp_xy [S, N], lm_xy [S, P]: (x, y) pairs, 8-byte aligned.
// blockIdx.y is the sequence: every array is a stack of S contiguous
// per-sequence slabs (a slab keeps its base's alignment: 256 N, 8 N, 256 P B
// and 8 P bytes are multiples of 16 and 8), the block moves each pointer
// to its sequence's slab and then works within it, so arg is an index
// into the sequence's own P.
__global__ void __launch_bounds__(kLmThreads)
landmark_top2_kernel(const uint8_t* __restrict__ kp,
                     const bool* __restrict__ kp_valid,
                     const float2* __restrict__ kp_xy,
                     const uint8_t* __restrict__ bank,
                     const bool* __restrict__ bank_valid,
                     const float2* __restrict__ lm_xy,
                     const bool* __restrict__ lm_valid, float r2, int n,
                     int p, int nb, int* __restrict__ best_out,
                     int* __restrict__ second_out, int* __restrict__ arg_out,
                     bool* __restrict__ any_out) {
  __shared__ float2 s_xy[kLmChunk];  // NaN: invalid or padding
  const int lane = threadIdx.x & 31;
  const int group = lane / kHitLanes, sub = lane % kHitLanes;
  const int row = blockIdx.x * kLmWarps + (threadIdx.x >> 5);
  {
    const size_t seq = blockIdx.y;
    const size_t kp0 = seq * n, lm0 = seq * p;
    kp += kp0 * 256;
    kp_valid += kp0;
    kp_xy += kp0;
    bank += lm0 * nb * 256;
    bank_valid += lm0 * nb;
    lm_xy += lm0;
    lm_valid += lm0;
    best_out += kp0;
    second_out += kp0;
    arg_out += kp0;
    any_out += kp0;
  }
  const bool active = row < n && kp_valid[row];  // the same for the warp
  Bytes32 kb = {};
  float2 kxy = make_float2(0.f, 0.f);
  if (active) {
    kb = load32(kp + static_cast<size_t>(row) * 256, sub);
    kxy = kp_xy[row];
  }
  const float nan = __int_as_float(0x7fc00000);

  // this group's running top-2 over its hits: key (d << 23) | j
  uint32_t best = kNoKey;
  int second = kPad;
  bool any = false;
  for (int base = 0; base < p; base += kLmChunk) {
    const int cnt = min(kLmChunk, p - base);
    const int padded = (cnt + kLmPad - 1) / kLmPad * kLmPad;
    __syncthreads();  // the previous chunk is gated by every warp
    // every load first (an index past cnt reloads landmark base), then
    // the stores: the loads travel together
    float2 xy[kLmChunk / kLmThreads];
    bool ok[kLmChunk / kLmThreads];
#pragma unroll
    for (int k = 0; k < kLmChunk / kLmThreads; ++k) {
      const int i = k * kLmThreads + threadIdx.x;
      const int from = base + (i < cnt ? i : 0);
      xy[k] = lm_xy[from];
      ok[k] = i < cnt && lm_valid[from];
    }
#pragma unroll
    for (int k = 0; k < kLmChunk / kLmThreads; ++k) {
      const int i = k * kLmThreads + threadIdx.x;
      if (i < padded) s_xy[i] = ok[k] ? xy[k] : make_float2(nan, nan);
    }
    __syncthreads();
    if (!active) continue;

    // Gate, kUnroll steps at a time: at step k lane l tests landmark
    // base + 32 k + l into bit k of its mask. No branch and no vote
    // inside a round.
    uint64_t mine = 0;
    for (int k0 = 0; 32 * k0 < cnt; k0 += kUnroll) {
      uint32_t bits = 0;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float2 l = s_xy[32 * (k0 + u) + lane];
        // the gate in the plain version's rounding: no fused multiply-add
        const float dx = __fsub_rn(kxy.x, l.x);
        const float dy = __fsub_rn(kxy.y, l.y);
        bits |= static_cast<uint32_t>(
                    __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)) < r2)
                << u;
      }
      mine |= static_cast<uint64_t>(bits) << k0;
    }
    uint64_t steps = mine;  // the steps with a hit in any lane
#pragma unroll
    for (int off = 1; off < 32; off <<= 1)
      steps |= __shfl_xor_sync(kFull, steps, off);
    any |= steps != 0u;
    if (nb == 0) continue;  // no bank slot: every hit is at 256

    // Hits, kBatch at a time: group g takes the batch's g-th hit and
    // merges it into its own top-2 (the key merge is order-free). The
    // bank bytes of the next batch are loaded before this one is summed,
    // so their round trip overlaps this batch's work.
    uint32_t cur = 0u;  // hits left in the current step
    int cur_base = 0;
    // the next batch: group g's hit (-1 if the batch has fewer), and the
    // hit every lane loads (a group without one loads the batch's first)
    auto next_batch = [&](int& hit_j, int& load_j) {
      hit_j = -1;
      int count = 0;
      while (count < kBatch && (steps | cur)) {
        if (!cur) {
          const int k = __ffsll(steps) - 1;
          steps &= steps - 1;
          cur = __ballot_sync(kFull, (mine >> k) & 1u);
          cur_base = base + 32 * k;
        }
        const int hit = cur_base + __ffs(cur) - 1;
        cur &= cur - 1;
        if (group == count) hit_j = hit;
        ++count;
      }
      const int first = __shfl_sync(kFull, hit_j, 0);
      load_j = hit_j >= 0 ? hit_j : first;
      return count;
    };
    int hit_j, load_j;
    int count = next_batch(hit_j, load_j);
    BankPass pass = {};
    if (count) pass = load_pass(bank, bank_valid, load_j, nb, 0, sub);
    while (count) {
      int next_hit, next_load;
      const int next_count = next_batch(next_hit, next_load);
      BankPass next = {};
      if (next_count)
        next = load_pass(bank, bank_valid, next_load, nb, 0, sub);
      int d = pass_min(pass, kb, kPad);
      for (int s0 = kSlotsPerPass; s0 < nb; s0 += kSlotsPerPass)
        d = pass_min(load_pass(bank, bank_valid, load_j, nb, s0, sub), kb,
                     d);
      if (hit_j >= 0) top2_add(d, static_cast<uint32_t>(hit_j), best, second);
      hit_j = next_hit;
      load_j = next_load;
      count = next_count;
      pass = next;
    }
  }

  // merge the four groups' top-2
#pragma unroll
  for (int off = kHitLanes; off < 32; off <<= 1)
    top2_merge(best, second, __shfl_xor_sync(kFull, best, off),
               __shfl_xor_sync(kFull, second, off));
  if (row < n && lane == 0) {
    best_out[row] = static_cast<int>(best >> kArgBits);
    second_out[row] = second;
    arg_out[row] = static_cast<int>(best & kArgMask);
    any_out[row] = any;
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
                        const void* lm_valid, float r2, int num_seq, int n,
                        int p, int nb, void* best, void* second, void* arg,
                        void* any, void* stream) {
  if (n <= 0 || num_seq <= 0) return static_cast<int>(cudaSuccess);
  if (p < 0 || p > static_cast<int>(kArgMask) + 1 || nb < 0 ||
      nb > kMaxBank || num_seq > kMaxSequences)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kLmWarps - 1) / kLmWarps, num_seq);
  landmark_top2_kernel<<<grid, kLmThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(kp), static_cast<const bool*>(kp_valid),
      static_cast<const float2*>(kp_xy), static_cast<const uint8_t*>(bank),
      static_cast<const bool*>(bank_valid),
      static_cast<const float2*>(lm_xy), static_cast<const bool*>(lm_valid),
      r2, n, p, nb, static_cast<int*>(best), static_cast<int*>(second),
      static_cast<int*>(arg), static_cast<bool*>(any));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
