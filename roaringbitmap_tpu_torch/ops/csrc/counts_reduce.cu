// Wide OR/XOR straight off nibble occurrence counts, for Hopper (sm_90a).
//
// Replaces two TPU kernels of roaringbitmap_tpu/ops/kernels.py:
//   B4 counts_segmented_reduce  (the counts-resident layout)
//   B6 fused_nibble_reduce      (the compact layout's fused query: counts
//                                built per query, plus each segment's
//                                dense-row partial folded in at its head)
// The layouts hold, per group of 8 rows, 4-bit occurrence counts of every
// bit position, plane-major: plane p of group g is u32[2048] at
// counts[g, p*2048 .. p*2048+2047], and nibble j of word w of plane p counts
// bit 8p + j of word w.  A count becomes a bit (or: count != 0, xor: count
// odd) by the SWAR conversion of roaringbitmap_tpu/ops/dense.py
// counts_tile_to_word, done here in registers.
//
// The TPU kernels walked the groups in one sequential grid and carried the
// segment's word tile in VMEM.  Here, as in segmented_reduce.cu, block
// (k, s) owns segment k and word slice s; the wrapper turns the sorted group
// segment ids into group ranges [start, end).  Each thread owns four
// consecutive words, reads their four planes as 16-byte loads, converts and
// folds them in order.  The segment's cardinality is one int32 atomic add
// per warp.  B6 differs from B4 in one place: the accumulator starts at the
// segment's dense-row partial instead of 0.  The TPU kernel folded the
// partial into the head group's word (op(word, partial)); or and xor commute
// and associate, so starting from it gives the same bits.
//
// Bound on the H100: device-memory bytes.  Each count group (32 KiB) is read
// once and each output row (8 KiB) written once; B6 also reads one 8 KiB
// partial row per segment.  The conversion is a few dozen integer
// operations per word, far below the memory time.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kVecPerPlane = 2048 / 4;               // uint4 per plane
constexpr int kVecPerGroup = 4 * kVecPerPlane;
constexpr int kThreads = 128;
constexpr int kSlices = kVecPerPlane / kThreads;

enum Op { kOr = 0, kXor = 2 };

// nibble counts -> the 8 bit flags of one byte plane, in the low byte
template <int OP>
__device__ __forceinline__ uint32_t plane_byte(uint32_t c) {
  uint32_t m;
  if (OP == kOr) {
    uint32_t t = c | (c >> 1);
    t |= t >> 2;
    m = t & 0x11111111u;
  } else {
    m = c & 0x11111111u;
  }
  const uint32_t v = (m | (m >> 3)) & 0x03030303u;
  const uint32_t w = (v | (v >> 6)) & 0x000F000Fu;
  return (w | (w >> 12)) & 0xFFu;
}

template <int OP>
__device__ __forceinline__ uint32_t to_word(uint32_t c0, uint32_t c1,
                                            uint32_t c2, uint32_t c3) {
  return plane_byte<OP>(c0) | (plane_byte<OP>(c1) << 8) |
         (plane_byte<OP>(c2) << 16) | (plane_byte<OP>(c3) << 24);
}

template <int OP>
__device__ __forceinline__ uint32_t fold(uint32_t a, uint32_t b) {
  return OP == kOr ? (a | b) : (a ^ b);
}

// HAS_PARTIAL false: B4 (partial unused); true: B6, partial u32[K+1, 2048]
template <int OP, bool HAS_PARTIAL>
__global__ void __launch_bounds__(kThreads)
counts_reduce_kernel(const uint4* __restrict__ counts,
                     const uint4* __restrict__ partial,
                     const int32_t* __restrict__ starts,
                     const int32_t* __restrict__ ends,
                     uint4* __restrict__ out, int32_t* __restrict__ cards) {
  const int seg = blockIdx.x;
  const int col = blockIdx.y * kThreads + threadIdx.x;
  const int64_t start = starts[seg];
  const int64_t end = ends[seg];
  // or and xor have 0 as identity; B6 starts from the segment's partial
  uint4 acc = make_uint4(0u, 0u, 0u, 0u);
  if constexpr (HAS_PARTIAL) {
    acc = __ldg(partial + static_cast<int64_t>(seg) * kVecPerPlane + col);
  }
  for (int64_t g = start; g < end; ++g) {
    const uint4* base = counts + g * kVecPerGroup + col;
    const uint4 p0 = __ldg(base);
    const uint4 p1 = __ldg(base + kVecPerPlane);
    const uint4 p2 = __ldg(base + 2 * kVecPerPlane);
    const uint4 p3 = __ldg(base + 3 * kVecPerPlane);
    acc.x = fold<OP>(acc.x, to_word<OP>(p0.x, p1.x, p2.x, p3.x));
    acc.y = fold<OP>(acc.y, to_word<OP>(p0.y, p1.y, p2.y, p3.y));
    acc.z = fold<OP>(acc.z, to_word<OP>(p0.z, p1.z, p2.z, p3.z));
    acc.w = fold<OP>(acc.w, to_word<OP>(p0.w, p1.w, p2.w, p3.w));
  }
  out[static_cast<int64_t>(seg) * kVecPerPlane + col] = acc;
  int n = __popc(acc.x) + __popc(acc.y) + __popc(acc.z) + __popc(acc.w);
  for (int off = 16; off > 0; off >>= 1) n += __shfl_down_sync(0xffffffffu, n, off);
  if ((threadIdx.x & 31) == 0 && n) atomicAdd(cards + seg, n);
}

template <bool HAS_PARTIAL>
int launch(const void* counts, const void* partial, const void* starts,
           const void* ends, void* out, void* cards, int num_segments, int op,
           void* stream) {
  const dim3 grid(num_segments, kSlices);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint4* c = static_cast<const uint4*>(counts);
  const uint4* p = static_cast<const uint4*>(partial);
  const int32_t* st = static_cast<const int32_t*>(starts);
  const int32_t* en = static_cast<const int32_t*>(ends);
  uint4* o = static_cast<uint4*>(out);
  int32_t* k = static_cast<int32_t*>(cards);
  switch (op) {
    case kOr:
      counts_reduce_kernel<kOr, HAS_PARTIAL><<<grid, kThreads, 0, s>>>(c, p, st, en, o, k);
      break;
    case kXor:
      counts_reduce_kernel<kXor, HAS_PARTIAL><<<grid, kThreads, 0, s>>>(c, p, st, en, o, k);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// B4.  counts u32[G, 4*2048], starts/ends i32[K] group ranges, out
// u32[K, 2048], cards i32[K] (zeroed by the caller).  op 0 = or, 2 = xor.
extern "C" int rb_counts_reduce(const void* counts, const void* starts,
                                const void* ends, void* out, void* cards,
                                int num_segments, int op, void* stream) {
  return launch<false>(counts, nullptr, starts, ends, out, cards,
                       num_segments, op, stream);
}

// B6.  As B4, plus partial u32[K+1, 2048]: segment k's accumulator starts
// at partial[k] (row K, the scratch segment's, is never read).
extern "C" int rb_nibble_reduce(const void* counts, const void* partial,
                                const void* starts, const void* ends,
                                void* out, void* cards, int num_segments,
                                int op, void* stream) {
  return launch<true>(counts, partial, starts, ends, out, cards,
                      num_segments, op, stream);
}

extern "C" const char* rb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
