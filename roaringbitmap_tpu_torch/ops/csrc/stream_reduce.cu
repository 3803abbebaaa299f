// Wide OR/XOR straight off a resident set's compact streams, for Hopper
// (sm_90a): B7.
//
// B7 replaces no TPU kernel.  On the TPU a scatter into VMEM was dear, so
// the counts layout streamed 4-bit occurrence counts, 32 KiB a group of 8
// rows whatever the group held (B4, counts_reduce.cu), and the dense layout
// streamed its whole image, 8 KiB a row (B2).  On Hopper a scatter into
// shared memory is cheap, so each key's head is built from the containers
// themselves: a key of the uscensus2000-shaped sets holds a median of one
// container of ~4 values, and B4 read 32 KiB of counts for it; a key of the
// census1881_srt-shaped sets holds ~45 containers, mostly runs, and B2 read
// ~56 rows of 8 KiB for it.
//
// Two variants, chosen at compile time by the layout that launches them:
//   - RUNS = false (the counts layout): values and dense-wire rows, one
//     4-byte value load a thread at a time;
//   - RUNS = true (the dense layout): values, run pairs and dense-wire rows,
//     the values read with 16-byte loads, two in flight a thread.
//
// Computes (values i32[V] sorted by destination row, dense-wire rows
// u32[Md, 2048] sorted the same way, per-key offsets voff i64[K+1] and doff
// i32[K+1]; with RUNS also runs u32[R], each a (start, length - 1) u16 pair
// as serialized, start in the low half, sorted the same way, and roff
// i64[K+1]) -> (u32[K, 2048] heads, i32[K] cards).  For each key k:
//   1. zero an 8 KiB head in shared memory;
//   2. (RUNS) set the bits of the runs [roff[k], roff[k+1]) (or) or toggle
//      them (xor).  Runs of one row never overlap, runs of different rows
//      of one key may, so every word a run touches takes the run's mask by
//      atomicOr (or) or atomicXor (xor: a bit two rows' runs share
//      cancels).  A thread takes a run of up to kLongRunWords + 1 words
//      alone; a longer run is spread over the lanes of its warp;
//   3. scatter the values [voff[k], voff[k+1]) into it with shared atomicOr
//      (or) or atomicXor (xor).  The xor is exact: one row never holds a
//      value twice, so a value present in an even number of the key's rows
//      cancels, as in FastAggregation.xor;
//   4. fold the dense rows [doff[k], doff[k+1]) into the head word-wise,
//      each thread owning its 16-byte columns of the shared head, with no
//      atomics and no barrier;
//   5. write the head with streaming stores (st.global.cs), so that the
//      heads, ~0.5 GB an op at the uscensus2000 shape, do not churn L2;
//   6. reduce the popcount over the block into cards[k].
// A key with no entries writes a zero head and a zero cardinality, so the
// wrapper allocates both outputs with torch.empty.
//
// Grid: one block a key, 128 threads, 16 blocks an SM (8 KiB of shared
// memory each).  A key's work is a chain of two dependent loads (its offsets,
// then its payload), one barrier-separated scatter and one 8 KiB store; with
// 16 keys in flight an SM the hardware scheduler walks the keys with no
// loop state, and 65,400 keys are ~31 waves on 132 SMs.  A persistent grid
// would have to double-buffer shared memory to overlap one key's store with
// the next key's loads, which resident blocks already do.  With one 4-byte
// load in flight a thread, 16 blocks of 128 threads keep 8 KiB in flight an
// SM, about a third of what HBM needs: enough for ~9 values a key, not for
// the ~11,000 of a census1881-shaped key, which RUNS reads 32 bytes at a
// time a thread.
//
// Heavy keys: a key that reads more than piece_bytes (4 bytes a value and a
// run pair, 8 KiB a dense row) would hold one SM for its whole read.  The
// host cuts it into pieces (ops/kernels.py stream_reduce_plan); blocks
// [0, P) take the pieces, so they start first, and block P + k takes key k,
// returning at once when key k is cut.  A piece builds its partial head as
// above, publishes it to a workspace slot (st.global.cg, kept in L2), fences
// and counts itself in on the key's counter; the block that brings the
// counter to the key's piece count folds the other pieces' partials
// (ld.global.cg) into its own and writes the head.  The counters are zeroed
// at launch.
//
// Bound on the H100: device-memory bytes: the heads written (8 KiB a key),
// the values and run pairs (4 bytes each), the dense rows and the offsets
// read once.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWords = 2048;
constexpr int kVecs = kWords / 4;                 // uint4 columns of a head
constexpr int kThreads = 128;
constexpr int kVecPerThread = kVecs / kThreads;
constexpr int kBlocksPerSm = 16;
constexpr int64_t kRowBytes = 4 * kWords;
constexpr int kPieceCols = 8;                     // ops/kernels.py B7_PIECE_COLS
constexpr int kRunPieceCols = 10;                 // B7_RUN_PIECE_COLS
// a run over more than kLongRunWords + 1 words is spread over a warp's lanes
constexpr uint32_t kLongRunWords = 3;

enum Op { kOr = 0, kXor = 2 };

struct Args {
  const int32_t* values;   // [V] u16 values widened
  const int64_t* voff;     // [k + 1]
  const uint4* dense;      // [md, kVecs]
  const int32_t* doff;     // [k + 1]
  const int64_t* pieces;   // [n_pieces, kPieceCols (kRunPieceCols: RUNS)]
  uint4* out;              // [k, kVecs]
  int32_t* cards;          // [k]
  uint4* partials;         // [n_pieces, kVecs]
  int32_t* counters;       // [n_split], zero at launch
  int64_t piece_bytes;
  int k, n_pieces;
  const uint32_t* runs;    // [R] (RUNS only)
  const int64_t* roff;     // [k + 1] (RUNS only)
};

template <int OP>
__device__ __forceinline__ uint4 fold4(uint4 a, uint4 b) {
  if (OP == kOr) return make_uint4(a.x | b.x, a.y | b.y, a.z | b.z, a.w | b.w);
  return make_uint4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
}

__device__ __forceinline__ int popc4(uint4 v) {
  return __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
}

// the bits m of word w set (or) or toggled (xor) in the shared head
template <int OP>
__device__ __forceinline__ void put_word(uint32_t* head, uint32_t w,
                                         uint32_t m) {
  if (OP == kOr) {
    atomicOr(head + w, m);
  } else {
    atomicXor(head + w, m);
  }
}

// one value's bit set (or) or toggled (xor) in the shared head
template <int OP>
__device__ __forceinline__ void put_value(uint32_t* head, int32_t value) {
  const uint32_t v = static_cast<uint32_t>(value) & 0xFFFFu;
  put_word<OP>(head, v >> 5, 1u << (v & 31));
}

template <int OP>
__device__ __forceinline__ void put_value4(uint32_t* head, int4 v) {
  put_value<OP>(head, v.x);
  put_value<OP>(head, v.y);
  put_value<OP>(head, v.z);
  put_value<OP>(head, v.w);
}

// The values [v0, v1) with 16-byte loads: the first up to three values (to a
// 16-byte boundary) and the last up to three one a thread, the aligned middle
// as int4, two loads in flight a thread.  values must be 16-byte aligned.
template <int OP>
__device__ __forceinline__ void put_values_wide(uint32_t* head,
                                                const int32_t* values,
                                                int64_t v0, int64_t v1,
                                                int tid) {
  const int64_t h1 = min((v0 + 3) & ~int64_t{3}, v1);
  const int64_t a1 = max(v1 & ~int64_t{3}, h1);
  if (tid < h1 - v0) put_value<OP>(head, __ldg(values + v0 + tid));
  if (tid >= 32 && tid - 32 < v1 - a1)
    put_value<OP>(head, __ldg(values + a1 + (tid - 32)));
  const int4* q = reinterpret_cast<const int4*>(values);
  const int64_t q1 = a1 >> 2;
  int64_t i = (h1 >> 2) + tid;
  for (; i + kThreads < q1; i += 2 * kThreads) {
    const int4 x = __ldg(q + i);
    const int4 y = __ldg(q + i + kThreads);
    put_value4<OP>(head, x);
    put_value4<OP>(head, y);
  }
  if (i < q1) put_value4<OP>(head, __ldg(q + i));
}

// the bits of word w inside the run [s, e]
__device__ __forceinline__ uint32_t run_mask(uint32_t w, uint32_t s,
                                             uint32_t e) {
  const uint32_t lo = w == (s >> 5) ? (s & 31u) : 0u;
  const uint32_t hi = w == (e >> 5) ? (e & 31u) : 31u;
  return (0xFFFFFFFFu >> (31u - hi)) & (0xFFFFFFFFu << lo);
}

// The runs [r0, r1): each word a run touches takes the run's mask, with
// atomicOr (or) or atomicXor (xor).  Warp w takes runs [r0 + 32 w,
// r0 + 32 w + 32), then each 128th after; a lane applies its own run when
// it spans at most kLongRunWords + 1 words, and the warp's lanes stride
// together over the words of each longer one.
template <int OP>
__device__ __forceinline__ void put_runs(uint32_t* head, const uint32_t* runs,
                                         int64_t r0, int64_t r1, int tid) {
  const int lane = tid & 31;
  for (int64_t base = r0 + (tid & ~31); base < r1; base += kThreads) {
    const int64_t i = base + lane;
    uint32_t s = 0, e = 0;
    if (i < r1) {
      const uint32_t p = __ldg(runs + i);
      s = p & 0xFFFFu;
      // the host checks that no run passes 65535; the clamp keeps a state
      // from elsewhere inside the head
      e = min(s + (p >> 16), 65535u);
    }
    const bool spread = i < r1 && (e >> 5) - (s >> 5) > kLongRunWords;
    if (i < r1 && !spread) {
      for (uint32_t w = s >> 5; w <= (e >> 5); ++w)
        put_word<OP>(head, w, run_mask(w, s, e));
    }
    for (unsigned m = __ballot_sync(0xFFFFFFFFu, spread); m; m &= m - 1) {
      const int src = __ffs(m) - 1;
      const uint32_t ls = __shfl_sync(0xFFFFFFFFu, s, src);
      const uint32_t le = __shfl_sync(0xFFFFFFFFu, e, src);
      for (uint32_t w = (ls >> 5) + lane; w <= (le >> 5); w += 32)
        put_word<OP>(head, w, run_mask(w, ls, le));
    }
  }
}

template <int OP, bool RUNS>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
stream_reduce_kernel(const Args a) {
  __shared__ __align__(16) uint32_t s_head[kWords];
  __shared__ int s_warp[kThreads / 32];
  __shared__ int s_last;
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  int key, piece = -1, first = 0, count = 1, ctr = 0;
  int64_t v0, v1, d0, d1, r0 = 0, r1 = 0;
  if (b < a.n_pieces) {
    const int64_t* p =
        a.pieces + static_cast<int64_t>(b) * (RUNS ? kRunPieceCols : kPieceCols);
    key = static_cast<int>(p[0]);
    v0 = p[1];
    v1 = p[2];
    d0 = p[3];
    d1 = p[4];
    first = static_cast<int>(p[5]);
    count = static_cast<int>(p[6]);
    ctr = static_cast<int>(p[7]);
    if (RUNS) {
      r0 = p[8];
      r1 = p[9];
    }
    piece = b;
  } else {
    key = b - a.n_pieces;
    v0 = __ldg(a.voff + key);
    v1 = __ldg(a.voff + key + 1);
    d0 = __ldg(a.doff + key);
    d1 = __ldg(a.doff + key + 1);
    if (RUNS) {
      r0 = __ldg(a.roff + key);
      r1 = __ldg(a.roff + key + 1);
    }
    // a cut key: its pieces build its head (the host cuts by this rule)
    if (4 * (v1 - v0) + 4 * (r1 - r0) + kRowBytes * (d1 - d0) > a.piece_bytes)
      return;
  }

  uint4* s4 = reinterpret_cast<uint4*>(s_head);
#pragma unroll
  for (int j = 0; j < kVecPerThread; ++j)
    s4[j * kThreads + tid] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  if (RUNS) {
    put_runs<OP>(s_head, a.runs, r0, r1, tid);
    put_values_wide<OP>(s_head, a.values, v0, v1, tid);
  } else {
    for (int64_t i = v0 + tid; i < v1; i += kThreads)
      put_value<OP>(s_head, __ldg(a.values + i));
  }
  __syncthreads();

  // From here each thread works on its own columns of the shared head, one
  // 16-byte column at a time (one uint4 live: no spills at 32 registers).
  if (d1 > d0) {
#pragma unroll 1
    for (int j = 0; j < kVecPerThread; ++j) {
      const int c = j * kThreads + tid;
      uint4 acc = s4[c];
#pragma unroll 4
      for (int64_t d = d0; d < d1; ++d)
        acc = fold4<OP>(acc, __ldg(a.dense + d * kVecs + c));
      s4[c] = acc;
    }
  }

  if (piece >= 0) {
    uint4* mine = a.partials + static_cast<int64_t>(piece) * kVecs;
#pragma unroll
    for (int j = 0; j < kVecPerThread; ++j)
      __stcg(mine + j * kThreads + tid, s4[j * kThreads + tid]);
    __threadfence();
    __syncthreads();
    if (tid == 0) s_last = atomicAdd(a.counters + ctr, 1) == count - 1;
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    for (int q = first; q < first + count; ++q) {
      if (q == piece) continue;
      const uint4* other = a.partials + static_cast<int64_t>(q) * kVecs;
#pragma unroll
      for (int j = 0; j < kVecPerThread; ++j) {
        const int c = j * kThreads + tid;
        s4[c] = fold4<OP>(s4[c], __ldcg(other + c));
      }
    }
  }

  uint4* head = a.out + static_cast<int64_t>(key) * kVecs;
  int n = 0;
#pragma unroll
  for (int j = 0; j < kVecPerThread; ++j) {
    const uint4 v = s4[j * kThreads + tid];
    __stcs(head + j * kThreads + tid, v);
    n += popc4(v);
  }
  for (int off = 16; off > 0; off >>= 1) n += __shfl_down_sync(0xffffffffu, n, off);
  if ((tid & 31) == 0) s_warp[tid >> 5] = n;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) total += s_warp[w];
    a.cards[key] = total;
  }
}

template <int OP, bool RUNS>
cudaError_t launch(const Args& a, cudaStream_t s) {
  static bool carved = false;
  if (!carved) {
    // 16 blocks of 8 KiB an SM: ask for the shared-memory carveout
    const cudaError_t err = cudaFuncSetAttribute(
        stream_reduce_kernel<OP, RUNS>,
        cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    carved = true;
  }
  stream_reduce_kernel<OP, RUNS><<<a.n_pieces + a.k, kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// B7.  values i32[V], voff i64[k + 1], dense u32[md, 2048], doff i32[k + 1],
// pieces i64[n_pieces, 8] (ops/kernels.py stream_reduce_plan), out
// u32[k, 2048] and cards i32[k] (neither initialised), partials
// u32[n_pieces, 2048] and counters i32[n_split] (a workspace, neither
// initialised), 16-byte aligned where rows.  roff null: the counts layout's
// variant; roff i64[k + 1]: the dense layout's, which also reads runs u32[R]
// (may be null where roff is all zero), pieces of 10 columns and values
// 16-byte aligned.  op 0 = or, 2 = xor.  Returns cudaGetLastError() after
// the launch.
extern "C" int rb_stream_reduce(const void* values, const void* voff,
                                const void* dense, const void* doff,
                                const void* pieces, void* out, void* cards,
                                void* partials, void* counters,
                                const void* runs, const void* roff,
                                int num_segments, int n_pieces, int n_split,
                                int64_t piece_bytes, int op, void* stream) {
  if (num_segments < 1 || n_pieces < 0 || n_split < 0 || piece_bytes < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.values = static_cast<const int32_t*>(values);
  a.voff = static_cast<const int64_t*>(voff);
  a.dense = static_cast<const uint4*>(dense);
  a.doff = static_cast<const int32_t*>(doff);
  a.pieces = static_cast<const int64_t*>(pieces);
  a.out = static_cast<uint4*>(out);
  a.cards = static_cast<int32_t*>(cards);
  a.partials = static_cast<uint4*>(partials);
  a.counters = static_cast<int32_t*>(counters);
  a.piece_bytes = piece_bytes;
  a.k = num_segments;
  a.n_pieces = n_pieces;
  a.runs = static_cast<const uint32_t*>(runs);
  a.roff = static_cast<const int64_t*>(roff);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_split > 0) {
    const cudaError_t err =
        cudaMemsetAsync(counters, 0, sizeof(int32_t) * n_split, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const bool with_runs = roff != nullptr;
  switch (op) {
    case kOr:
      return static_cast<int>(with_runs ? launch<kOr, true>(a, s)
                                        : launch<kOr, false>(a, s));
    case kXor:
      return static_cast<int>(with_runs ? launch<kXor, true>(a, s)
                                        : launch<kXor, false>(a, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* rb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
