// The dense image of a set's compact streams, built once, for Hopper
// (sm_90a): B8.
//
// B8 replaces no TPU kernel.  The JAX package builds the image with a
// scatter-add that XLA compiles (roaringbitmap_tpu/ops/dense.py
// densify_streams), and the port's plain version does the same in PyTorch:
// an int64 buffer twice the image's size, then int64 and int32 copies to
// fold it back, some seven images at peak.  On Hopper each row is built in
// shared memory and written once, so the card holds the image and the
// streams and nothing more, and run containers reach the card as runs.
//
// Computes (dense-wire rows u32[Md, 2048], values i32[V], runs u32[R] (each
// a (start, length - 1) u16 pair as serialized, start in the low half),
// and the per-row plan: value offsets voff i64[n + 1], run offsets roff
// i64[n + 1], the dense-wire row of each row drow i32[n] (-1: none)) ->
// u32[n, 2048] rows.  For row r:
//   1. a row with no values and no runs (a bitmap container's, or block
//      padding) is its dense-wire row copied, or zeros, stored straight
//      from registers;
//   2. any other: an 8 KiB row in shared memory starts as its dense-wire
//      row or zeros; warp w takes runs w, w + 4, ... of the row, its lanes
//      stride over the run's words: a word the run covers whole is stored
//      (no other run of the container touches it), an edge word takes
//      atomicOr; the threads stride over the row's values with atomicOr of
//      one bit each;
//   3. the row is stored with 16-byte coalesced stores.
// One container maps to one row, so no two blocks write one row and every
// row is written exactly once: the wrapper allocates the image with
// torch.empty.
//
// Grid: one block a row, 128 threads, 16 blocks an SM (8 KiB of shared
// memory each), as B7 runs.  A row's work is a chain of two dependent
// loads (its plan, then its payload), one scatter and one 8 KiB store; the
// hardware scheduler walks the rows with 16 in flight an SM.
//
// Bound on the H100: device-memory bytes, chiefly the image written (8 KiB
// a row); the values and runs (4 bytes each), the dense-wire rows (8 KiB
// each) and the plan (20 bytes a row) are read once.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWords = 2048;
constexpr int kVecs = kWords / 4;                 // uint4 columns of a row
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kVecPerThread = kVecs / kThreads;
constexpr int kBlocksPerSm = 16;

struct Args {
  const uint4* dense;      // [md, kVecs]
  const int32_t* drow;     // [n]
  const int32_t* values;   // [V] u16 values widened
  const int64_t* voff;     // [n + 1]
  const uint32_t* runs;    // [R]
  const int64_t* roff;     // [n + 1]
  uint4* out;              // [n, kVecs]
};

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
row_build_kernel(const Args a) {
  __shared__ __align__(16) uint32_t s_row[kWords];
  const int tid = threadIdx.x;
  const int64_t r = blockIdx.x;
  const int64_t v0 = __ldg(a.voff + r), v1 = __ldg(a.voff + r + 1);
  const int64_t r0 = __ldg(a.roff + r), r1 = __ldg(a.roff + r + 1);
  const int d = __ldg(a.drow + r);
  const uint4* src = d >= 0 ? a.dense + static_cast<int64_t>(d) * kVecs
                            : nullptr;
  uint4* dst = a.out + r * kVecs;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  if (v0 == v1 && r0 == r1) {
#pragma unroll
    for (int j = 0; j < kVecPerThread; ++j) {
      const int c = j * kThreads + tid;
      dst[c] = src ? __ldg(src + c) : zero;
    }
    return;
  }

  uint4* s4 = reinterpret_cast<uint4*>(s_row);
#pragma unroll
  for (int j = 0; j < kVecPerThread; ++j) {
    const int c = j * kThreads + tid;
    s4[c] = src ? __ldg(src + c) : zero;
  }
  __syncthreads();

  const int lane = tid & 31;
  for (int64_t i = r0 + (tid >> 5); i < r1; i += kWarps) {
    const uint32_t p = __ldg(a.runs + i);
    const uint32_t s = p & 0xFFFFu;
    // the host checks that no run passes 65535; the clamp keeps a state
    // from elsewhere inside the row
    const uint32_t e = min(s + (p >> 16), 65535u);
    const uint32_t w0 = s >> 5, w1 = e >> 5;
    for (uint32_t w = w0 + lane; w <= w1; w += 32) {
      const uint32_t lo = w == w0 ? (s & 31u) : 0u;
      const uint32_t hi = w == w1 ? (e & 31u) : 31u;
      const uint32_t m = (0xFFFFFFFFu >> (31u - hi)) & (0xFFFFFFFFu << lo);
      if (m == 0xFFFFFFFFu) {
        s_row[w] = m;
      } else {
        atomicOr(s_row + w, m);
      }
    }
  }
  for (int64_t i = v0 + tid; i < v1; i += kThreads) {
    const uint32_t v = static_cast<uint32_t>(__ldg(a.values + i)) & 0xFFFFu;
    atomicOr(s_row + (v >> 5), 1u << (v & 31u));
  }
  __syncthreads();

#pragma unroll
  for (int j = 0; j < kVecPerThread; ++j) {
    const int c = j * kThreads + tid;
    dst[c] = s4[c];
  }
}

// 16 blocks of 8 KiB an SM: ask once for the shared-memory carveout.  The
// call also loads the kernel's module (CUDA loads modules lazily), so a
// launch after it carries neither.
cudaError_t carve() {
  static bool carved = false;
  if (carved) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      row_build_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) carved = true;
  return err;
}

}  // namespace

// Readies B8 before its first launch (ops/kernels.py CudaKernel.load), so
// that CUDA events around that launch time the kernel alone.
extern "C" int rb_row_build_prepare() { return static_cast<int>(carve()); }

// B8.  dense u32[md, 2048], drow i32[n_rows], values i32[V], voff
// i64[n_rows + 1], runs u32[R] (may be null where roff is all zero), roff
// i64[n_rows + 1], out u32[n_rows, 2048] (not initialised), 16-byte aligned
// where rows.  Returns cudaGetLastError() after the launch.
extern "C" int rb_row_build(const void* dense, const void* drow,
                            const void* values, const void* voff,
                            const void* runs, const void* roff, void* out,
                            int n_rows, void* stream) {
  if (n_rows < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows == 0) return static_cast<int>(cudaSuccess);
  const cudaError_t err = carve();
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a;
  a.dense = static_cast<const uint4*>(dense);
  a.drow = static_cast<const int32_t*>(drow);
  a.values = static_cast<const int32_t*>(values);
  a.voff = static_cast<const int64_t*>(voff);
  a.runs = static_cast<const uint32_t*>(runs);
  a.roff = static_cast<const int64_t*>(roff);
  a.out = static_cast<uint4*>(out);
  row_build_kernel<<<n_rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
