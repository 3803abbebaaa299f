// Ragged per-key bitwise reduce with a fused popcount, for Hopper (sm_90a).
//
// Replaces two TPU kernels of roaringbitmap_tpu/ops/kernels.py:
//   B1 segmented_reduce_pallas          (:61, one row per grid step)
//   B2 segmented_reduce_pallas_blocked  (:116, block rows of one segment per step)
// Both walked the rows in one sequential grid and carried each segment's
// accumulator in VMEM from step to step.  CUDA blocks run in no order, so
// the reduce is planned again for the card.  Both compute
// (u32[M, W] rows, sorted i32 ids, K) -> (u32[K, W] heads, i32[K] cards):
// the op (or, and, xor, andnot) applied in row order, andnot as
// head & ~(or of the rest); id K marks padding rows, which nothing reads;
// a segment with no rows gives zeros.  B2 is the same kernel reading one
// id per block of rows (`scale`); its padding rows inside a segment are
// zero, the identity of or and xor, the only ops it takes.
//
// Bound on the H100: device-memory bytes at 3.35 TB/s.  Each input row is
// read once and each head written once, with one bitwise op per word.
//
// What held the first design (PR 1) back: block (k, s) walked segment k's
// rows over word slice s alone, so the grid was K x (W / 512) blocks
// whatever the bytes, and each thread held four 16-byte loads in flight.
// On phase 6's pack (131,072 rows, K 256, ~441 rows a segment; NVIDIA H100
// 80GB HBM3 at 700 W) that reached 61.6, 49.4, 21.6 and 23.3% of the bound
// at 2048, 1024, 512 and 256 words: a 256-word row meant 256 blocks of 2
// warps, ~8 KiB in flight an SM, and the wrapper ran two searchsorted
// passes and a zero fill first.  The chunked design:
//
// - Block c takes chunk c: rows [cR, cR + R) of the whole array, R chosen
//   by the wrapper (ops/kernels.py b1_chunk_rows) for a fixed number of
//   blocks an SM at every width, whatever K and the segment lengths are.
//   A segment of at most R rows is folded whole by the chunk its head row
//   lies in (it writes its head and popcount directly, with no workspace);
//   a longer one is split at the chunk edges.  The block finds which rows
//   it owns from the ids of rows [cR - R, cR + 2R), staged in shared
//   memory: no device-to-host read, no prologue launch, so the call is one
//   launch and can be captured in a CUDA graph.
// - Every row of a block is the full row width: 256 threads (512 at 2048
//   words), one 16-byte column each, and at narrow widths G row groups of
//   W/4 threads each take every G-th row, folded in shared memory at the
//   end of a run.  Each thread keeps 8 row loads in flight: 128 KiB an SM at
//   every width, against the few tens of KiB HBM latency asks for.
// - A split segment's pieces are partials in a workspace (two slots a
//   chunk).  Each piece adds to a per-segment counter after a
//   __threadfence(): the head piece adds 1 + c, a middle piece 1, the tail
//   piece 1 - (c + 1) = -c, so the sum reaches 0 exactly when the last piece
//   arrives, and that block folds the partials in chunk order (the head
//   chunk's first; for andnot head & ~(or of the others)), writes the head
//   and the popcount.  The counter ends the launch at 0; the launch zeroes
//   the counters first all the same (the workspace is not initialised).
//   The bitwise result does not depend on the split; a card is one block's
//   exact int32 sum.
// - A block also zeroes the empty segments whose id gap starts in its rows.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

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

__device__ __forceinline__ int popc4(uint4 v) {
  return __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
}

constexpr int kUnroll = 8;            // row loads each thread has in flight
constexpr int kMaxChunkRows = 1024;   // ops/kernels.py B1_MAX_CHUNK_ROWS

// The op a run folds its rows with after the head: andnot folds the rest
// with or and applies it to the head once.
template <int OP>
__host__ __device__ constexpr int rest_op() { return OP == kAndNot ? kOr : OP; }

template <int OP>
__device__ __forceinline__ uint4 identity4() {
  const uint32_t v = OP == kAnd ? 0xffffffffu : 0u;
  return make_uint4(v, v, v, v);
}

template <int COLS>
__host__ __device__ constexpr int block_threads() { return COLS < 256 ? 256 : COLS; }

struct ChunkArgs {
  const uint4* rows;       // [m, cols]
  const int32_t* seg;      // [ceil(m / scale)] sorted ids, K = padding
  uint4* out;              // [k, cols]
  int32_t* cards;          // [k]
  uint4* partials;         // [2 * chunks, cols]: slot 0 a piece continued
                           // from the chunk before, slot 1 a head piece
  int32_t* counters;       // [k], zero at launch
  int32_t* ends;           // [2 * k]: first and last chunk of a split segment
  int m, k, chunk_rows, scale;
};

// Folds the n items of a run (rows, or a split segment's partials) in the
// threads of one block: thread (g, col) takes items g, g + G, ... of column
// col, kUnroll loads in flight, and the G row groups meet in shared memory.
// With `head`, item 0 is the segment's head row: andnot keeps it aside and
// returns head & ~(or of the rest).  The value is valid in row group 0.
template <int OP, int COLS, typename Addr, typename Load>
__device__ uint4 fold_run(Addr addr, Load load, int n, bool head, int g,
                          int col, uint4* s_acc) {
  constexpr int T = block_threads<COLS>();
  constexpr int G = T / COLS;
  constexpr int RO = rest_op<OP>();
  const bool keep_head = OP == kAndNot && head;
  uint4 acc = identity4<RO>();
  uint4 h = make_uint4(0u, 0u, 0u, 0u);
  if (keep_head && g == 0) h = load(addr(0) + col);
  for (int j = (keep_head ? 1 : 0) + g; j < n; j += G * kUnroll) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int jj = j + u * G;
      v[u] = jj < n ? load(addr(jj) + col) : identity4<RO>();
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc = apply4<RO>(acc, v[u]);
  }
  if constexpr (G > 1) {
    __syncthreads();                   // the previous run's readers are done
    s_acc[threadIdx.x] = acc;
    __syncthreads();
    if (g == 0) {
#pragma unroll
      for (int i = 1; i < G; ++i) acc = apply4<RO>(acc, s_acc[i * COLS + col]);
    }
  }
  return keep_head ? apply4<kAndNot>(h, acc) : acc;
}

// The block's sum of one int a thread, returned to every thread.
template <int T>
__device__ __forceinline__ int block_sum(int n, int* s_warp) {
  n = __reduce_add_sync(0xffffffffu, n);
  __syncthreads();                     // s_warp's previous readers are done
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = n;
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int i = 0; i < T / 32; ++i) total += s_warp[i];
  return total;
}

struct LoadRows {   // input rows, read once: the read-only path
  __device__ uint4 operator()(const uint4* p) const { return __ldg(p); }
};
struct LoadL2 {     // partials other blocks wrote in this launch
  __device__ uint4 operator()(const uint4* p) const { return __ldcg(p); }
};

// Slots of the block's plan in shared memory.
enum { kFirstPad, kStart0, kEnd0, kStartL, kEndL, kGaps, kLastArrival,
       kPlanSlots };

template <int OP, int COLS>
__global__ void __launch_bounds__(block_threads<COLS>(),
                                  1024 / block_threads<COLS>())
chunk_reduce_kernel(ChunkArgs p) {
  constexpr int T = block_threads<COLS>();
  extern __shared__ int32_t smem[];
  __shared__ uint4 s_acc[T / COLS > 1 ? T : 1];
  __shared__ int s_warp[T / 32];
  __shared__ int s_plan[kPlanSlots];

  const int R = p.chunk_rows, m = p.m, K = p.k;
  const int tid = threadIdx.x, g = tid / COLS, col = tid % COLS;
  const int c = blockIdx.x, last_chunk = gridDim.x - 1;
  const int lo = c * R, hi = min(lo + R, m), base = lo - R;
  int32_t* s_ids = smem;               // ids of rows [base, base + 3R)
  int32_t* s_gaps = smem + 3 * R;      // empty segments [a, b), <= R + 1

  // Stage the ids around the chunk (-1 before row 0, K from row m on).
  for (int i = tid; i < 3 * R; i += T) {
    const int r = base + i;
    s_ids[i] = r < 0 ? -1 : (r >= m ? K : __ldg(p.seg + r / p.scale));
  }
  if (tid == 0) {
    s_plan[kFirstPad] = hi;
    s_plan[kStart0] = s_plan[kStartL] = base - 1;        // before the window
    s_plan[kEnd0] = s_plan[kEndL] = base + 3 * R + 1;    // past the window
    s_plan[kGaps] = 0;
  }
  __syncthreads();
  auto id = [&](int r) { return s_ids[r - base]; };

  // The chunk's real rows are [lo, hr): ids are sorted, so every row from
  // the first padding row on is padding.
  for (int r = lo + tid; r < hi; r += T)
    if (id(r) == K && (r == lo || id(r - 1) != K)) s_plan[kFirstPad] = r;
  __syncthreads();
  const int hr = s_plan[kFirstPad];
  const int k0 = hr > lo ? id(lo) : K;        // the run at the first row
  const int kl = hr > lo ? id(hr - 1) : K;    // the run at the last real row

  // Run boundaries in the window: where k0's and kl's runs start and end
  // (each boundary is written by one thread), and the empty segments whose
  // transition row the chunk owns (the last chunk also owns row m).
  for (int r = base + 1 + tid; r < base + 3 * R; r += T) {
    const int a = id(r - 1), b = id(r);
    if (a == b) continue;
    if (b == k0) s_plan[kStart0] = r;
    if (a == k0) s_plan[kEnd0] = r;
    if (b == kl) s_plan[kStartL] = r;
    if (a == kl) s_plan[kEndL] = r;
    if (b > a + 1 && ((r >= lo && r < hi) || (r == m && c == last_chunk))) {
      const int i = atomicAdd(&s_plan[kGaps], 1);
      s_gaps[2 * i] = a + 1;
      s_gaps[2 * i + 1] = b;
    }
  }
  __syncthreads();

  const int n_gaps = s_plan[kGaps];
  for (int i = 0; i < n_gaps; ++i) {
    const int a = s_gaps[2 * i], b = s_gaps[2 * i + 1];
    const int64_t n = static_cast<int64_t>(b - a) * COLS;
    uint4* o = p.out + static_cast<int64_t>(a) * COLS;
    for (int64_t e = tid; e < n; e += T) o[e] = make_uint4(0u, 0u, 0u, 0u);
    for (int kk = a + tid; kk < b; kk += T) p.cards[kk] = 0;
  }
  if (hr <= lo) return;

  // The rows the chunk folds, [p0, p1).  A run is short when it has at most
  // R rows (a boundary outside the window means it has more): a short run
  // belongs to the chunk of its head row, whole; a long one is cut at the
  // chunk edges.
  const int s0 = s_plan[kStart0], e0 = s_plan[kEnd0];
  const int sl = s_plan[kStartL], el = s_plan[kEndL];
  const bool before0 = s0 < lo, short0 = e0 - s0 <= R;
  const int p0 = before0 && short0 ? e0 : lo;
  const int p1 = sl < lo ? (short0 ? p0 : hr) : (el - sl <= R ? el : hr);
  const int lane = tid & 31;

  for (int a = p0; a < p1;) {
    const int k = id(a);
    int b = a + 1;
    for (;;) {                          // the run's end, 32 ids a step
      const int r = b + lane;
      const unsigned diff = __ballot_sync(0xffffffffu, r >= p1 || id(r) != k);
      if (diff) { b += __ffs(diff) - 1; break; }
      b += 32;
    }
    const bool before = a == lo && before0;           // continues a piece
    const bool after = b == hr && hr < m && id(hr) == k;   // continues on
    const uint4* run = p.rows + static_cast<int64_t>(a) * COLS;
    uint4 v = fold_run<OP, COLS>(
        [&](int j) { return run + static_cast<int64_t>(j) * COLS; },
        LoadRows(), b - a, !before, g, col, s_acc);
    bool write = !before && !after;
    if (!write) {
      // A piece of a split segment: publish it, then count it in.
      if (g == 0)
        p.partials[static_cast<int64_t>(2 * c + (before ? 0 : 1)) * COLS + col] = v;
      if (tid == 0) {
        if (!before) p.ends[2 * k] = c;
        if (!after) p.ends[2 * k + 1] = c;
      }
      __threadfence();
      __syncthreads();
      if (tid == 0) {
        const int add = 1 + (before ? 0 : c) - (after ? 0 : c + 1);
        s_plan[kLastArrival] = atomicAdd(p.counters + k, add) + add == 0;
      }
      __syncthreads();
      write = s_plan[kLastArrival];
      if (write) {
        // The last piece to arrive: fold the partials in chunk order.
        __threadfence();
        const int cf = before ? __ldcg(p.ends + 2 * k) : c;
        const int cl = after ? __ldcg(p.ends + 2 * k + 1) : c;
        const uint4* parts = p.partials;
        v = fold_run<OP, COLS>(
            [&](int j) {
              return parts + static_cast<int64_t>(2 * (cf + j) + (j ? 0 : 1)) * COLS;
            },
            LoadL2(), cl - cf + 1, true, g, col, s_acc);
      }
    }
    if (write) {
      if (g == 0) p.out[static_cast<int64_t>(k) * COLS + col] = v;
      const int n = block_sum<T>(g == 0 ? popc4(v) : 0, s_warp);
      if (tid == 0) p.cards[k] = n;
    }
    a = b;
  }
}

template <int OP, int COLS>
cudaError_t launch_chunks(const ChunkArgs& a, int chunks, cudaStream_t s) {
  const size_t smem = (5 * static_cast<size_t>(a.chunk_rows) + 2) * sizeof(int32_t);
  chunk_reduce_kernel<OP, COLS>
      <<<chunks, block_threads<COLS>(), smem, s>>>(a);
  return cudaGetLastError();
}

template <int COLS>
cudaError_t launch_chunks_op(int op, const ChunkArgs& a, int chunks,
                             cudaStream_t s) {
  switch (op) {
    case kOr: return launch_chunks<kOr, COLS>(a, chunks, s);
    case kAnd: return launch_chunks<kAnd, COLS>(a, chunks, s);
    case kXor: return launch_chunks<kXor, COLS>(a, chunks, s);
    case kAndNot: return launch_chunks<kAndNot, COLS>(a, chunks, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// B1 and B2.  rows u32[m, width], seg i32[ceil(m / scale)] sorted (scale
// rows per id), out u32[k, width], cards i32[k] (neither initialised),
// work i32 of 2 * chunks * width + 3 * k (partials, counters, ends; chunks
// = max(1, ceil(m / chunk_rows))), 16-byte aligned; width 2048, 1024, 512
// or 256 words; 1 <= chunk_rows <= 1024.  Returns cudaGetLastError() after
// the launch.
extern "C" int rb_segmented_reduce_chunked(const void* rows, const void* seg,
                                           void* out, void* cards, void* work,
                                           int m, int num_segments, int op,
                                           int width, int chunk_rows,
                                           int scale, void* stream) {
  if (m < 0 || num_segments < 1 || chunk_rows < 1 ||
      chunk_rows > kMaxChunkRows || scale < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = m > 0 ? (m + chunk_rows - 1) / chunk_rows : 1;
  const int cols = width / 4;
  int32_t* w = static_cast<int32_t*>(work);
  ChunkArgs a;
  a.rows = static_cast<const uint4*>(rows);
  a.seg = static_cast<const int32_t*>(seg);
  a.out = static_cast<uint4*>(out);
  a.cards = static_cast<int32_t*>(cards);
  a.partials = reinterpret_cast<uint4*>(w);
  a.counters = w + static_cast<int64_t>(2) * chunks * width;
  a.ends = a.counters + num_segments;
  a.m = m;
  a.k = num_segments;
  a.chunk_rows = chunk_rows;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chunks > 1) {
    const cudaError_t err = cudaMemsetAsync(
        a.counters, 0, sizeof(int32_t) * num_segments, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaError_t err;
  switch (cols) {
    case 512: err = launch_chunks_op<512>(op, a, chunks, s); break;
    case 256: err = launch_chunks_op<256>(op, a, chunks, s); break;
    case 128: err = launch_chunks_op<128>(op, a, chunks, s); break;
    case 64: err = launch_chunks_op<64>(op, a, chunks, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* rb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
