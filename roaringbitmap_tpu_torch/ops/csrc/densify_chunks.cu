// Chunked value stream -> dense container image, for Hopper (sm_90a): B3.
//
// Replaces roaringbitmap_tpu/ops/kernels.py densify_chunks_impl (:286) /
// densify_chunks_pallas (:272).  The TPU kernel walked the chunks in row
// order, carried each row's tile in VMEM across the row's consecutive chunks
// (building a chunk's bits with a one-hot matrix product on the MXU, since
// the TPU has no fast scatter), and wrote every row once, masking rows that
// own no chunk to zero.  The same on the card: block r owns output row r.
//   1. Zero an 8 KiB tile of the row in shared memory.
//   2. The threads take the slots of the row's chunks [bounds[r],
//      bounds[r + 1]) with 16-byte loads (four values a thread) and OR
//      1 << (v & 31) into tile[v >> 5] with shared-memory atomics.  Slots
//      holding CHUNK_PAD (any v > 0xFFFF) contribute nothing.
//   3. After a barrier, store the tile to out[r] with coalesced 16-byte
//      stores.
// A row that owns no chunk stores its zero tile, so every row of the image is
// written exactly once and the caller allocates it uninitialised: no zero
// fill of the image, and no read-modify-write of device memory.  The launch
// plan (ops/kernels.py densify_chunk_bounds) is the chunk stream's row
// bounds, which a resident set computes once when it loads its stream; so
// the stream must be sorted by row, which this kernel does not check (the
// wrapper checks it on the CPU only).  Chunks of the scratch row
// n_rows (or of any row outside [0, n_rows)) lie outside [bounds[0],
// bounds[n_rows]) and are never read.
//
// Bound on the H100: device-memory bytes, the chunk stream and its rows read
// once and the image written once (the image dominates: 8 KiB a row against
// about 1.7 KiB of chunks a row for bitmaps of 0.25% density).  The atomics
// stay in shared memory, and the tile's zeroing and store are 16-byte
// accesses, so what is left per row is the store of its 8 KiB.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWords = 2048;
constexpr int kVecs = kWords / 4;    // 16-byte vectors of a row
constexpr int kThreads = 256;

__device__ __forceinline__ void set_bit(uint32_t* tile, uint32_t v) {
  if (v <= 0xFFFFu) atomicOr(tile + (v >> 5), 1u << (v & 31u));
}

// at most 32 registers a thread, so that eight blocks (2,048 threads and
// 64 KiB of tiles) fit on an SM and keep enough stores in flight
__global__ void __launch_bounds__(kThreads, 8)
densify_rows_kernel(const uint4* __restrict__ chunk_vals,
                    const int32_t* __restrict__ bounds,
                    uint4* __restrict__ out, int chunk_vecs) {
  __shared__ __align__(16) uint32_t tile[kWords];
  uint4* tile4 = reinterpret_cast<uint4*>(tile);
  const int row = blockIdx.x;
  const int t = threadIdx.x;
  const int64_t v0 = static_cast<int64_t>(__ldg(bounds + row)) * chunk_vecs;
  const int64_t v1 =
      static_cast<int64_t>(__ldg(bounds + row + 1)) * chunk_vecs;
  for (int i = t; i < kVecs; i += kThreads) tile4[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  for (int64_t i = v0 + t; i < v1; i += kThreads) {
    const uint4 q = __ldg(chunk_vals + i);
    set_bit(tile, q.x);
    set_bit(tile, q.y);
    set_bit(tile, q.z);
    set_bit(tile, q.w);
  }
  __syncthreads();
  uint4* dst = out + static_cast<int64_t>(row) * kVecs;
  for (int i = t; i < kVecs; i += kThreads) dst[i] = tile4[i];
}

}  // namespace

// chunk_vals u32[NC, chunk] (chunk a multiple of 4), bounds i32[n_rows + 1]
// (row r owns chunks [bounds[r], bounds[r + 1])), out u32[n_rows, 2048],
// every row of which is written.  Returns cudaGetLastError() after the
// launch.
extern "C" int rb_densify_chunks(const void* chunk_vals, const void* bounds,
                                 void* out, int chunk, int n_rows,
                                 void* stream) {
  densify_rows_kernel<<<static_cast<unsigned>(n_rows), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(chunk_vals),
      static_cast<const int32_t*>(bounds), static_cast<uint4*>(out),
      chunk / 4);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
