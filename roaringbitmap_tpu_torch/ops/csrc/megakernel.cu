// Instruction-stream megakernel for Hopper (sm_90a): B5.
//
// Replaces roaringbitmap_tpu/ops/megakernel.py _kernel (:140), launched by
// _raw_call (:911).  The TPU ran the stream as one sequential grid, one step
// per grid point, with every accumulator slot (a 2048-word container row) in
// up to 8 MiB of VMEM.  A block here has at most 227 KB of shared memory and
// blocks run in no order, so the work is split by word instead of by step:
// every opcode except TAKE is word-wise, so the row is cut into 128 slices of
// 16 words, and block c of a cooperative launch runs the WHOLE stream over
// slice c, thread t owning word 16c + t of every slot.  A thread only ever
// touches its own words, so word-wise steps need no barrier.  Per step:
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
// integer work is 2048 word ops per step.  The design is latency-bound
// instead: each step is a dependent stream load, then a row load.  The loop
// fetches the next step and its row before this step's work, so one row load
// is in flight behind each step; deeper prefetch (a cp.async ring) is later
// work.  The wrapper checks every index of the stream on the host, so the
// kernel never reads out of range; bank offsets are 64-bit.

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

struct Step {
  int opc, dst, src, row, bank, orow, crow, imm;
};

// stream is int32[8, stride]: opc, dst, src, row, bank, orow, crow, imm
__device__ __forceinline__ Step load_step(const int32_t* __restrict__ s,
                                          int stride, int i) {
  Step st;
  st.opc = __ldg(s + i);
  st.dst = __ldg(s + stride + i);
  st.src = __ldg(s + 2 * stride + i);
  st.row = __ldg(s + 3 * stride + i);
  st.bank = __ldg(s + 4 * stride + i);
  st.orow = __ldg(s + 5 * stride + i);
  st.crow = __ldg(s + 6 * stride + i);
  st.imm = __ldg(s + 7 * stride + i);
  return st;
}

__device__ __forceinline__ bool reads_row(int opc) {
  switch (opc) {
    case kLoadRow: case kOrRow: case kAndRow: case kXorRow:
    case kAndNotRowRev: case kAndNotRow: case kVscanHi: case kVscanLo:
    case kVaggCard:
      return true;
    default:
      return false;
  }
}

__device__ __forceinline__ uint32_t load_row(const Step& st,
                                             const uint32_t* __restrict__ a,
                                             const uint32_t* __restrict__ b,
                                             const uint32_t* __restrict__ c,
                                             int word) {
  if (!reads_row(st.opc)) return 0u;
  const uint32_t* base = st.bank == 0 ? a : (st.bank == 1 ? b : c);
  return __ldg(base + static_cast<int64_t>(st.row) * kWords + word);
}

// sum over the block's 16 lanes; lane 0 holds the result
__device__ __forceinline__ uint32_t block_sum(uint32_t v) {
  for (int off = kSliceWords / 2; off > 0; off >>= 1)
    v += __shfl_down_sync(kLanes, v, off);
  return v;
}

__global__ void __launch_bounds__(kSliceWords)
megakernel(const int32_t* __restrict__ stream, int stride, int steps,
           const uint32_t* __restrict__ bank_a,
           const uint32_t* __restrict__ bank_b,
           const uint32_t* __restrict__ bank_c,
           uint32_t* __restrict__ out, int32_t* __restrict__ cards,
           uint32_t* take_part, int n_slots, int out_pad, int card_pad) {
  extern __shared__ uint32_t acc[];   // [n_slots][kSliceWords]
  cg::grid_group grid = cg::this_grid();
  const int t = threadIdx.x;
  const int c = blockIdx.x;
  const int word = c * kSliceWords + t;
  for (int s = 0; s < n_slots; ++s) acc[s * kSliceWords + t] = 0u;

  int n_take = 0;
  Step st = load_step(stream, stride, 0);
  uint32_t w = load_row(st, bank_a, bank_b, bank_c, word);
  for (int i = 0; i < steps; ++i) {
    Step nx = st;
    uint32_t nw = 0u;
    if (i + 1 < steps) {
      nx = load_step(stream, stride, i + 1);
      nw = load_row(nx, bank_a, bank_b, bank_c, word);
    }
    const uint32_t cur = acc[st.dst * kSliceWords + t];
    const uint32_t srcv = acc[st.src * kSliceWords + t];
    uint32_t res = cur;
    switch (st.opc) {
      case kLoadRow: res = w; break;
      case kOrRow: res = cur | w; break;
      case kAndRow: res = cur & w; break;
      case kXorRow: res = cur ^ w; break;
      case kAndNotRowRev: res = w & ~cur; break;
      case kZero: res = 0u; break;
      case kCopySlot: res = srcv; break;
      case kOrSlot: res = cur | srcv; break;
      case kAndSlot: res = cur & srcv; break;
      case kXorSlot: res = cur ^ srcv; break;
      case kAndNotSlot: res = cur & ~srcv; break;
      case kAndNotRow: res = cur & ~w; break;
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
        for (int j = 0; j < kSlices; ++j) total += __ldcg(part + j);
        ++n_take;
        res = static_cast<int32_t>(total) < st.imm ? 0xFFFFFFFFu : 0u;
        break;
      }
      default: break;   // NOP, OUT, CARD, VAGG_CARD keep acc[dst]
    }
    acc[st.dst * kSliceWords + t] = res;
    if (st.orow < out_pad)
      out[static_cast<int64_t>(st.orow) * kWords + word] = srcv;
    if (st.crow < card_pad) {
      const uint32_t cval = st.opc == kVaggCard ? (srcv & w) : srcv;
      const uint32_t n = block_sum(static_cast<uint32_t>(__popc(cval)));
      if (t == 0)
        cards[static_cast<int64_t>(st.crow) * kSlices + c] =
            static_cast<int32_t>(n);
    }
    st = nx;
    w = nw;
  }
}

}  // namespace

// stream i32[8, stride], of which the first steps columns run (the
// rest is the stream's power-of-two padding of NOPs); banks u32[rows, 2048];
// out u32[out_pad, 2048] and cards i32[card_pad, 128] zeroed by the caller;
// take_part u32[2 * 128] scratch.  Launches 128 blocks of 16 threads cooperatively with
// (slots_pad + 1) * 64 bytes of dynamic shared memory.  Returns the CUDA
// error of the attribute call or the launch (0 on success).
extern "C" int rb_megakernel(const void* stream, int stride, int steps,
                             const void* bank_a, const void* bank_b,
                             const void* bank_c, void* out, void* cards,
                             void* take_part, int slots_pad, int out_pad,
                             int card_pad, void* cuda_stream) {
  int n_slots = slots_pad + 1;
  const size_t smem =
      static_cast<size_t>(n_slots) * kSliceWords * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      megakernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int32_t* s = static_cast<const int32_t*>(stream);
  const uint32_t* a = static_cast<const uint32_t*>(bank_a);
  const uint32_t* b = static_cast<const uint32_t*>(bank_b);
  const uint32_t* c = static_cast<const uint32_t*>(bank_c);
  uint32_t* o = static_cast<uint32_t*>(out);
  int32_t* cd = static_cast<int32_t*>(cards);
  uint32_t* tp = static_cast<uint32_t*>(take_part);
  void* args[] = {&s, &stride, &steps, &a, &b, &c, &o, &cd, &tp,
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
