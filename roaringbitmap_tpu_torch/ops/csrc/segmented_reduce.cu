// Ragged per-key bitwise reduce with a fused popcount, for Hopper (sm_90a).
//
// Replaces two TPU kernels of roaringbitmap_tpu/ops/kernels.py:
//   B1 segmented_reduce_pallas          (one row per grid step)
//   B2 segmented_reduce_pallas_blocked  (block rows of one segment per step)
// Both walked the rows in one sequential grid and carried each segment's
// accumulator in VMEM from step to step.  CUDA blocks run in no order, so the
// reduce is re-planned segment-parallel: the wrapper turns the sorted segment
// ids into per-segment row ranges [start, end), and block (k, s) owns segment
// k and word slice s of the 2048-word row.  Its threads walk the segment's
// rows in order (the head row initialises, later rows apply op), which keeps
// andnot identical to B1's order, and keep the accumulator in registers.
// B2 is the same kernel over block-padded ranges: its padding rows are zero,
// the identity of or/xor.
//
// B1 also takes a row width (2048, 1024, 512 or 256 words): a mesh's
// "lanes" axis hands each shard a slice of every row, and the kernel walks
// rows of that width.  Block (k, s) then owns word slice s of the narrower
// row; a 256-word row is one slice of 64 threads.  B2 keeps 2048 words.
//
// Bound on the H100: device-memory bytes.  Each input row is read once
// (8 KiB) and each output row written once, with one bitwise op per word.
// Every thread issues 16-byte loads, neighbouring threads on neighbouring
// addresses, and four rows' loads are in flight before they are folded in
// order.  The word slices let K = 64..256 segments fill the card's 132 SMs
// without bitwise atomics; the only atomic is one int32 add per warp into
// the segment's cardinality, which is exact in any order.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;                        // one uint4 per thread

enum Op { kOr = 0, kAnd = 1, kXor = 2, kAndNot = 3 };

template <int OP>
__device__ __forceinline__ uint32_t apply(uint32_t a, uint32_t b) {
  if (OP == kOr) return a | b;
  if (OP == kAnd) return a & b;
  if (OP == kXor) return a ^ b;
  return a & ~b;
}

template <int OP>
__device__ __forceinline__ uint4 apply4(uint4 a, uint4 b) {
  return make_uint4(apply<OP>(a.x, b.x), apply<OP>(a.y, b.y),
                    apply<OP>(a.z, b.z), apply<OP>(a.w, b.w));
}

template <int OP>
__global__ void __launch_bounds__(kThreads)
seg_reduce_kernel(const uint4* __restrict__ rows,
                  const int32_t* __restrict__ starts,
                  const int32_t* __restrict__ ends,
                  uint4* __restrict__ out, int32_t* __restrict__ cards,
                  int vec_per_row) {
  const int seg = blockIdx.x;
  const int col = blockIdx.y * blockDim.x + threadIdx.x;
  const int64_t start = starts[seg];
  const int64_t end = ends[seg];
  uint4 acc = make_uint4(0u, 0u, 0u, 0u);
  if (start < end) {
    acc = __ldg(rows + start * vec_per_row + col);
    int64_t r = start + 1;
    for (; r + 4 <= end; r += 4) {
      const uint4 a = __ldg(rows + (r + 0) * vec_per_row + col);
      const uint4 b = __ldg(rows + (r + 1) * vec_per_row + col);
      const uint4 c = __ldg(rows + (r + 2) * vec_per_row + col);
      const uint4 d = __ldg(rows + (r + 3) * vec_per_row + col);
      acc = apply4<OP>(acc, a);
      acc = apply4<OP>(acc, b);
      acc = apply4<OP>(acc, c);
      acc = apply4<OP>(acc, d);
    }
    for (; r < end; ++r) acc = apply4<OP>(acc, __ldg(rows + r * vec_per_row + col));
  }
  out[static_cast<int64_t>(seg) * vec_per_row + col] = acc;
  int n = __popc(acc.x) + __popc(acc.y) + __popc(acc.z) + __popc(acc.w);
  for (int off = 16; off > 0; off >>= 1) n += __shfl_down_sync(0xffffffffu, n, off);
  if ((threadIdx.x & 31) == 0 && n) atomicAdd(cards + seg, n);
}

}  // namespace

// rows u32[M, width], starts/ends i32[K], out u32[K, width], cards i32[K]
// (zeroed by the caller); width is 2048, 1024, 512 or 256 words (B2 always
// passes 2048).  Returns cudaGetLastError() after the launch.
extern "C" int rb_segmented_reduce(const void* rows, const void* starts,
                                   const void* ends, void* out, void* cards,
                                   int num_segments, int op, int width,
                                   void* stream) {
  if (width != 2048 && width != 1024 && width != 512 && width != 256)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec = width / 4;
  const int threads = vec < kThreads ? vec : kThreads;
  const dim3 grid(num_segments, vec / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint4* r = static_cast<const uint4*>(rows);
  const int32_t* st = static_cast<const int32_t*>(starts);
  const int32_t* en = static_cast<const int32_t*>(ends);
  uint4* o = static_cast<uint4*>(out);
  int32_t* c = static_cast<int32_t*>(cards);
  switch (op) {
    case kOr: seg_reduce_kernel<kOr><<<grid, threads, 0, s>>>(r, st, en, o, c, vec); break;
    case kAnd: seg_reduce_kernel<kAnd><<<grid, threads, 0, s>>>(r, st, en, o, c, vec); break;
    case kXor: seg_reduce_kernel<kXor><<<grid, threads, 0, s>>>(r, st, en, o, c, vec); break;
    case kAndNot: seg_reduce_kernel<kAndNot><<<grid, threads, 0, s>>>(r, st, en, o, c, vec); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
