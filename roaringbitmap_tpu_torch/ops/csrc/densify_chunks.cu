// Chunked value stream -> dense container image, for Hopper (sm_90a).
//
// Replaces roaringbitmap_tpu/ops/kernels.py densify_chunks_impl /
// densify_chunks_pallas (B3).  The TPU kernel turned each 128-value chunk
// into a word tile with a one-hot matrix product on the MXU, because the TPU
// has no fast scatter, and carried each row's tile in VMEM across its chunks.
// The H100 has fast atomics, so that product is not ported: one thread takes
// one chunk slot and ORs its bit into the zeroed output,
//   out[row * 2048 + (v >> 5)] |= 1 << (v & 31).
// Slots holding CHUNK_PAD (any v > 0xFFFF) and chunks of the scratch row
// (row == n_rows) contribute nothing.  The caller zeroes the output, so rows
// that own no chunk stay zero: that is the TPU kernel's row_live mask.
//
// Bound on the H100: device-memory bytes (the chunk stream read once, the
// image written once) and, for dense chunks, the atomics.  Values in a chunk
// are sorted, so neighbouring lanes of a warp often hit the same word: the
// warp first ORs the bits of lanes that share a word (a shuffle scan over
// lanes with equal targets) and only the first lane of each run issues the
// atomic, which cuts the atomics of a dense chunk up to 32-fold.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWords = 2048;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
densify_chunks_kernel(const uint32_t* __restrict__ chunk_vals,
                      const int32_t* __restrict__ chunk_row,
                      uint32_t* __restrict__ out, int64_t n_slots,
                      int chunk, int n_rows) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  int64_t target = -1;   // flat word index, -1 = contributes nothing
  uint32_t bits = 0u;
  if (i < n_slots) {
    const uint32_t v = __ldg(chunk_vals + i);
    const int row = __ldg(chunk_row + i / chunk);
    if (v <= 0xFFFFu && row >= 0 && row < n_rows) {
      target = static_cast<int64_t>(row) * kWords + (v >> 5);
      bits = 1u << (v & 31u);
    }
  }
  // suffix OR over lanes with the same target: afterwards the first lane of
  // every run of equal targets holds the OR of the whole run
  for (int off = 1; off < 32; off <<= 1) {
    const int64_t t = __shfl_down_sync(0xffffffffu, target, off);
    const uint32_t b = __shfl_down_sync(0xffffffffu, bits, off);
    if (lane + off < 32 && t == target) bits |= b;
  }
  const int64_t prev = __shfl_up_sync(0xffffffffu, target, 1);
  const bool leader = lane == 0 || prev != target;
  if (leader && target >= 0) atomicOr(out + target, bits);
}

}  // namespace

// chunk_vals u32[NC, chunk], chunk_row i32[NC], out u32[n_rows, 2048]
// zeroed by the caller.  Returns cudaGetLastError() after the launch.
extern "C" int rb_densify_chunks(const void* chunk_vals, const void* chunk_row,
                                 void* out, long long n_slots, int chunk,
                                 int n_rows, void* stream) {
  const long long blocks = (n_slots + kThreads - 1) / kThreads;
  densify_chunks_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(chunk_vals),
      static_cast<const int32_t*>(chunk_row), static_cast<uint32_t*>(out),
      n_slots, chunk, n_rows);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
