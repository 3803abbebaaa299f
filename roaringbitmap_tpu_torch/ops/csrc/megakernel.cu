// Instruction-stream megakernel for Hopper (sm_90a): B5.
//
// Replaces roaringbitmap_tpu/ops/megakernel.py _kernel (:140), launched by
// _raw_call (:911).  The TPU ran the stream as one sequential grid, one step
// per grid point, with every accumulator slot (a 2048-word container row) in
// up to 8 MiB of VMEM and the pipeline's scalar prefetch bringing each
// step's row ahead.  A block here has at most 227 KB of shared memory and
// blocks run in no order, so the work is split by word instead of by step:
// every opcode except TAKE is word-wise, so the row is cut into 128 slices of
// 16 words, and block c of a cooperative launch runs the WHOLE stream over
// slice c, thread t owning word 16c + t of every slot.  Per step:
//   cur = acc[dst], srcv = acc[src], w = bank[row] (row-reading opcodes only);
//   acc[dst] = f(opcode, cur, srcv, w);
//   orow < out_pad:   out[orow] = srcv;
//   crow < card_pad:  cards[crow][c] = popcount(srcv, or srcv & w for
//                     VAGG_CARD) over the slice; the caller sums the slices.
// Rows past out_pad / card_pad are the stream's dead rows and are not stored.
// TAKE needs the sum of the whole counter row: each block writes its slice's
// sum (u32, i.e. int32 with wrap-around, as XLA sums) to a partial buffer,
// the grid syncs, and every block adds the 128 partials in the same order.
// Successive TAKEs alternate between two partial buffers, so a block still
// reading one TAKE's partials is never overwritten by the next (the TAKE in
// between syncs the grid again).
//
// Bound on the H100: device-memory bytes (one 8 KiB row per row-reading
// step, the out rows, the card partials, 32 B of stream per step); the
// integer work is 2048 word ops per step.  The steps form one dependent
// chain run by one half-warp per block, so the kernel is bound by the
// latency of a step instead: a step that loaded its own inputs (its stream
// record, then the row the record names) would wait for two device-memory
// round trips, and every dependent instruction of a step adds to its time.
// So a step's inputs come through shared memory, loaded ahead with
// cp.async, and its own work is short:
//   - the device copy of the stream is step-major, int32[steps, 8], so a
//     record is 32 contiguous bytes; the block stages it a chunk of
//     kRecs / 4 records at a time into a ring of kRecs (each thread copies
//     four 16-byte pieces at a chunk's first step, two chunks ahead; one
//     barrier a chunk shows them to all sixteen threads);
//   - every thread copies its own word of step i + D's row into a ring of D
//     stages, one copy group a step (empty when the step reads no row), and
//     before step i + 1 waits until at most D - 1 groups are pending; a
//     thread reads only the ring words it copied itself;
//   - step i's shared-memory loads of the next step's record and of step
//     i + D's record are issued before its own work, so their latency hides
//     behind it;
//   - the fifteen opcodes below VSCAN_HI are one branch-free formula over
//     three masks; VSCAN, ACC_POP and TAKE take a switch;
//   - the loop is unrolled twice, so that the compiler can interleave one
//     step's bookkeeping with the next step's loads.
// The banks are read-only, so a copy may be in flight across a TAKE's
// grid.sync().  kRecs and D come from the build as -D defines
// (ops/build.py DEFINES, from which ops/megakernel.py sizes the shared
// memory too): 128 records and D = 32 (16 ran no faster).  The wrapper
// checks every index of the stream on the host, so the kernel never reads
// out of range; bank offsets are 64-bit.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWords = 2048;
constexpr int kSlices = 128;
constexpr int kSliceWords = kWords / kSlices;            // threads per block
constexpr unsigned kLanes = (1u << kSliceWords) - 1u;    // the block's lanes

enum Opcode {
  kNop, kLoadRow, kOrRow, kAndRow, kXorRow, kAndNotRowRev, kZero,
  kCopySlot, kOrSlot, kAndSlot, kXorSlot, kAndNotSlot, kAndNotRow,
  kOut, kCard, kVscanHi, kVscanLo, kVaggCard, kAccPop, kTake
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void copy4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void commit_group() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// sum over the block's 16 lanes; lane 0 holds the result
__device__ __forceinline__ uint32_t block_sum(uint32_t v) {
  for (int off = kSliceWords / 2; off > 0; off >>= 1)
    v += __shfl_down_sync(kLanes, v, off);
  return v;
}

// The opcodes that read a bank row, and the three masks of the bitwise
// opcodes below VSCAN_HI: res = (cur & A) ^ (x & B) ^ (cur & x & C), x the
// row word for row opcodes and the src slot word for the others.  (OR is
// a ^ b ^ ab, ANDNOT a ^ ab, and so on; NOP, OUT and CARD keep cur.)
constexpr unsigned bit(int opc) { return 1u << opc; }
constexpr unsigned kRowOps = bit(kLoadRow) | bit(kOrRow) | bit(kAndRow)
    | bit(kXorRow) | bit(kAndNotRowRev) | bit(kAndNotRow) | bit(kVscanHi)
    | bit(kVscanLo) | bit(kVaggCard);
constexpr unsigned kMaskA = bit(kNop) | bit(kOrRow) | bit(kXorRow)
    | bit(kOrSlot) | bit(kXorSlot) | bit(kAndNotSlot) | bit(kAndNotRow)
    | bit(kOut) | bit(kCard);
constexpr unsigned kMaskB = bit(kLoadRow) | bit(kOrRow) | bit(kXorRow)
    | bit(kAndNotRowRev) | bit(kCopySlot) | bit(kOrSlot) | bit(kXorSlot);
constexpr unsigned kMaskC = bit(kOrRow) | bit(kAndRow) | bit(kAndNotRowRev)
    | bit(kOrSlot) | bit(kAndSlot) | bit(kAndNotSlot) | bit(kAndNotRow);

// all ones when bit opc of set is set, else 0 (opc < 32)
__device__ __forceinline__ uint32_t in_set(unsigned set, int opc) {
  return 0u - ((set >> opc) & 1u);
}

__device__ __forceinline__ bool reads_row(int opc) {
  return (kRowOps >> opc) & 1u;
}

// Step records are staged in a ring of kRecs in shared memory, kChunk at a
// time: lo = (opc, dst, src, row), hi = (bank, orow, crow, imm).  Rows come
// kDepth (D) steps ahead, through a ring of D stages.
#if !defined(RB_RECORD_RING) || !defined(RB_PREFETCH_DEPTH)
#error "build with -DRB_RECORD_RING and -DRB_PREFETCH_DEPTH (ops/build.py)"
#endif
constexpr int kRecs = RB_RECORD_RING;
constexpr int kChunk = kRecs / 4;
constexpr int kDepth = RB_PREFETCH_DEPTH;
static_assert(kRecs % 4 == 0, "the record ring holds four chunks");
static_assert(0 < kDepth && kDepth <= kChunk,
              "a step's prefetch record must be staged");

// the three row banks, indexed by a record's bank field (a kernel parameter,
// so the index is one constant-bank load)
struct Banks { const uint32_t* p[3]; };

__global__ void __launch_bounds__(kSliceWords)
megakernel(const int4* __restrict__ stream, int steps_cap,
           const int* __restrict__ steps_dev, const Banks banks,
           uint32_t* __restrict__ out, int32_t* __restrict__ cards,
           uint32_t* take_part, int n_slots, int out_pad, int card_pad) {
  // a captured launch reads its step count from the device, so that a
  // graph replays any plan of its stream shape (the NOP padding past the
  // count is never run)
  const int steps = steps_dev ? min(steps_cap, __ldg(steps_dev)) : steps_cap;
  extern __shared__ __align__(16) int4 smem[];
  int4* recs = smem;
  // [kRecs][2] records, [kDepth][16] row words, [n_slots][16] slots
  uint32_t* ring = reinterpret_cast<uint32_t*>(smem + 2 * kRecs);
  uint32_t* acc = ring + kDepth * kSliceWords;
  cg::grid_group grid = cg::this_grid();
  const int t = threadIdx.x;
  const int c = blockIdx.x;
  const int word = c * kSliceWords + t;
  for (int s = 0; s < n_slots; ++s) acc[s * kSliceWords + t] = 0u;

  // chunk k of the stream into the record ring, 4 x 16 bytes a thread
  auto fetch_chunk = [&](int k) {
    for (int q = t; q < 2 * kChunk; q += kSliceWords) {
      const int i = k * kChunk + q / 2;
      if (i < steps)
        copy16(recs + 2 * (i % kRecs) + (q & 1), stream + 2 * i + (q & 1));
    }
  };
  // this thread's word of the row a record names, into ring stage i % D
  auto fetch_row = [&](int i, int4 lo, int bank) {
    if (i >= steps || !reads_row(lo.x)) return;
    copy4(ring + (i % kDepth) * kSliceWords + t,
          banks.p[bank] + static_cast<int64_t>(lo.w) * kWords + word);
  };

  // prologue: chunks 0 and 1 in one group, then the rows of steps 0 .. D-1
  // in one group each
  fetch_chunk(0);
  fetch_chunk(1);
  commit_group();
  wait_pending<0>();
  __syncthreads();
  for (int i = 0; i < kDepth; ++i) {
    fetch_row(i, recs[2 * i], recs[2 * i + 1].x);
    commit_group();
  }
  wait_pending<kDepth - 1>();   // step 0's row
  int4 lo = recs[0], hi = recs[1];
  uint32_t w = reads_row(lo.x) ? ring[t] : 0u;

  int n_take = 0;
#pragma unroll 2
  for (int i = 0; i < steps; ++i) {
    // loads for later steps first, so that their latency overlaps this one
    const int j = i + 1;
    const int4 nlo = recs[2 * (j % kRecs)];
    const int4 nhi = recs[2 * (j % kRecs) + 1];
    const int p = i + kDepth;
    const int4 plo = recs[2 * (p % kRecs)];
    const int pbank = recs[2 * (p % kRecs) + 1].x;

    const int opc = lo.x;
    const uint32_t cur = acc[lo.y * kSliceWords + t];
    const uint32_t srcv = acc[lo.z * kSliceWords + t];
    uint32_t res;
    if (opc < kVscanHi) {
      const uint32_t row = in_set(kRowOps, opc);
      const uint32_t x = (w & row) | (srcv & ~row);
      res = (cur & in_set(kMaskA, opc)) ^ (x & in_set(kMaskB, opc))
          ^ (cur & x & in_set(kMaskC, opc));
    } else {
      switch (opc) {
        case kVscanHi: res = cur | (srcv & ~w); break;
        case kVscanLo: res = cur | (srcv & w); break;
        case kAccPop: res = cur + static_cast<uint32_t>(__popc(srcv)); break;
        case kTake: {
          uint32_t* part = take_part + (n_take & 1) * kSlices;
          const uint32_t mine = block_sum(srcv);
          if (t == 0) part[c] = mine;
          __threadfence();
          grid.sync();
          uint32_t total = 0u;
          for (int k = 0; k < kSlices; ++k) total += __ldcg(part + k);
          ++n_take;
          res = static_cast<int32_t>(total) < hi.w ? 0xFFFFFFFFu : 0u;
          break;
        }
        default: res = cur; break;   // VAGG_CARD keeps acc[dst]
      }
    }
    acc[lo.y * kSliceWords + t] = res;
    if (hi.y < out_pad)
      out[static_cast<int64_t>(hi.y) * kWords + word] = srcv;
    if (hi.z < card_pad) {
      const uint32_t cval = opc == kVaggCard ? (srcv & w) : srcv;
      const uint32_t n = block_sum(static_cast<uint32_t>(__popc(cval)));
      if (t == 0)
        cards[static_cast<int64_t>(hi.z) * kSlices + c] =
            static_cast<int32_t>(n);
    }

    // step i's ring stage is free: refill it with step i + D's row; at a
    // chunk's first step, stage the chunk after next
    fetch_row(p, plo, pbank);
    if (i % kChunk == 0) fetch_chunk(i / kChunk + 2);
    commit_group();
    // step i + 1's row (and, at a chunk's end, the next chunk) is complete
    wait_pending<kDepth - 1>();
    if (j % kChunk == 0) __syncthreads();
    lo = nlo;
    hi = nhi;
    w = reads_row(nlo.x) ? ring[(j % kDepth) * kSliceWords + t] : 0u;
  }
  wait_pending<0>();
}

}  // namespace

// stream i32[steps_pad, 8] step-major (opc, dst, src, row, bank, orow, crow,
// imm), of which the first steps records run (the rest is the stream's
// power-of-two padding of NOPs), or the first *steps_dev when steps_dev is
// not null (a device int32, read by every block at its start); banks
// u32[rows, 2048]; out u32[out_pad, 2048] and cards i32[card_pad, 128]
// zeroed by the caller; take_part u32[2 * 128] scratch.  Launches 128
// blocks of 16 threads cooperatively with 32 kRecs + 64 D + (slots_pad +
// 1) * 64 bytes of dynamic shared memory.
// Returns the CUDA error of the attribute call or the launch (0 on
// success).
extern "C" int rb_megakernel(const void* stream, int steps,
                             const void* steps_dev,
                             const void* bank_a, const void* bank_b,
                             const void* bank_c, void* out, void* cards,
                             void* take_part, int slots_pad, int out_pad,
                             int card_pad, void* cuda_stream) {
  const int4* s = static_cast<const int4*>(stream);
  Banks banks{{static_cast<const uint32_t*>(bank_a),
               static_cast<const uint32_t*>(bank_b),
               static_cast<const uint32_t*>(bank_c)}};
  uint32_t* o = static_cast<uint32_t*>(out);
  int32_t* cd = static_cast<int32_t*>(cards);
  uint32_t* tp = static_cast<uint32_t*>(take_part);
  int n_slots = slots_pad + 1;
  const size_t smem = static_cast<size_t>(2 * kRecs) * sizeof(int4)
      + static_cast<size_t>(kDepth + n_slots) * kSliceWords * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      megakernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int* sd = static_cast<const int*>(steps_dev);
  void* args[] = {&s, &steps, &sd, &banks, &o, &cd, &tp,
                  &n_slots, &out_pad, &card_pad};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(megakernel), dim3(kSlices),
      dim3(kSliceWords), args, smem, static_cast<cudaStream_t>(cuda_stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
