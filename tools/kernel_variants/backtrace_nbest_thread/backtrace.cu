// backtrace_nbest variant "thread": the N-best walk as it was before the
// walk was given a warp, kept to time against voicebridge_tpu_torch/csrc/
// backtrace.cu (tools/time_viterbi_kernels.py --variant thread=<this dir>).
// A thread per walk (lane, candidate), 128 walks to a CTA, so the 512 walks
// of the full-width N-best decode fill 4 SMs; each frame reads the arc and
// the slot, then arc_src of the arc: two dependent round trips.  Its C entry
// is vbt_backtrace_nbest_thread (the arcs' sources by original id in place
// of the checkout's row tables), so the timing tool can tell the two
// interfaces apart.  backtrace_best is the checkout's, unchanged.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 128;
constexpr unsigned kFull = 0xffffffffu;
// backtrace_best: threads a CTA (all copy the row starts; the first
// `lanes` warps walk a lane each) and the most shared memory it asks for
constexpr int kBestThreads = 256;
constexpr size_t kBestSmemLimit = 226 * 1024;

// backtrace_best: one warp per lane.  Per frame i, from the state s known
// to every thread of the warp:
//   rs, n   = the first slot of s's rows and their slot count
//   code    = bps[i, s]                              (one address, all threads)
//   cand_j  = row_src[rs + j] for j < n              (coalesced, beside the code)
//   s       = cand_code                              (a shuffle)
// so row_src no longer waits on the code: a frame is one round trip, the
// code's, where the plain chain is two.  Every thread issues both loads
// (threads past the state's slots repeat its last one) and the rare state
// of more than 32 slots is a warp vote: no divergent branch stands between
// the two loads, which would make them wait on each other.  The row starts
// come from shared memory, as row_start[x] - x in 16 bits (nondecreasing,
// at most R - S), when the table fits and R - S < 65536; else from global
// memory, one more round trip a frame.  A code of 32 or more (a state of more than 32 slots) reads
// row_src[g] after the code.  Thread j keeps the global code of the frame i
// with i % 32 == j; after each group of 32 frames (at i % 32 == 0) it
// stores the group's codes, reads their arc ids, and stores the arcs read
// at the group before (off the chain: the store waits on a load 32 frames
// old).
template <typename BP, bool kSmem>
__device__ __forceinline__ int best_walk(const BP* __restrict__ bps,
                                         const int* __restrict__ row_start,
                                         const uint16_t* __restrict__ rs16,
                                         const int* __restrict__ row_src,
                                         const int* __restrict__ row_arc, int n_act, int s1,
                                         int b, int d, int lane, int j, int s,
                                         int* __restrict__ codes, int* __restrict__ arcs) {
  int my_g = 0, arc_old = 0, old_i = -1;
  for (int i = n_act - 1; i >= 0; --i) {
    int rs, n_cand;
    if constexpr (kSmem) {
      const int lo = rs16[s];
      rs = s + lo;
      n_cand = (1 + rs16[s + 1] - lo) * d;
    } else {
      rs = __ldg(row_start + s);
      n_cand = (__ldg(row_start + s + 1) - rs) * d;
    }
    const int64_t first = static_cast<int64_t>(rs) * d;
    const int64_t row = static_cast<int64_t>(i) * s1;
    const int code = static_cast<int>(__ldg(bps + (row + s) * b + lane));
    const int cand = __ldg(row_src + first + min(j, n_cand - 1));
    const int g = static_cast<int>(first + code);
    my_g = j == (i & 31) ? g : my_g;
    s = __shfl_sync(kFull, cand, code & 31);
    if (__any_sync(kFull, code >= 32)) s = __ldg(row_src + g);  // a state of > 32 slots
    if ((i & 31) == 0) {  // the group of frames i .. i + 31 is walked
      if (old_i >= 0) arcs[static_cast<int64_t>(old_i) * b + lane] = arc_old;
      old_i = i + j < n_act ? i + j : -1;
      if (old_i >= 0) {
        codes[static_cast<int64_t>(old_i) * b + lane] = my_g;
        arc_old = __ldg(row_arc + my_g);
      }
    }
  }
  if (old_i >= 0) arcs[static_cast<int64_t>(old_i) * b + lane] = arc_old;
  return s;
}

// `lanes` walking warps a CTA; shared memory holds the 16-bit row starts
// when `staged` (the launcher found room for them).
template <typename BP>
__global__ void __launch_bounds__(kBestThreads)
backtrace_best_kernel(const BP* __restrict__ bps, const int* __restrict__ row_start,
                      const int* __restrict__ row_src, const int* __restrict__ row_arc,
                      const int* __restrict__ end_state, const int* __restrict__ num_frames,
                      int t0, int w, int s1, int b, int d, int lanes, bool staged,
                      int* __restrict__ codes, int* __restrict__ arcs,
                      int* __restrict__ state_out) {
  extern __shared__ uint16_t rs16[];  // [s1 + 1]: row_start[x] - x
  const int warp = threadIdx.x / 32;
  const int j = threadIdx.x % 32;
  const int lane = blockIdx.x * lanes + warp;  // the decode lane this warp walks
  const bool smem = staged && __ldg(row_start + s1) - s1 < 65536;
  if (smem) {
    const int n = s1 + 1;
    const int n4 = n / 4;  // row_start is 16-byte aligned (checked by the launcher)
    const int4* rs4 = reinterpret_cast<const int4*>(row_start);
#pragma unroll 4
    for (int x = threadIdx.x; x < n4; x += kBestThreads) {
      const int4 v = __ldg(rs4 + x);
      rs16[4 * x] = static_cast<uint16_t>(v.x - 4 * x);
      rs16[4 * x + 1] = static_cast<uint16_t>(v.y - 4 * x - 1);
      rs16[4 * x + 2] = static_cast<uint16_t>(v.z - 4 * x - 2);
      rs16[4 * x + 3] = static_cast<uint16_t>(v.w - 4 * x - 3);
    }
    for (int x = 4 * n4 + threadIdx.x; x < n; x += kBestThreads)
      rs16[x] = static_cast<uint16_t>(__ldg(row_start + x) - x);
    __syncthreads();
  }
  if (warp >= lanes || lane >= b) return;
  int s = __ldg(end_state + lane);
  const int n_act = max(0, min(__ldg(num_frames + lane) - t0, w));  // active: i < n_act
  for (int i = n_act + j; i < w; i += 32) {
    codes[static_cast<int64_t>(i) * b + lane] = -1;
    arcs[static_cast<int64_t>(i) * b + lane] = -1;
  }
  if (n_act > 0) {
    s = smem ? best_walk<BP, true>(bps, row_start, rs16, row_src, row_arc, n_act, s1, b, d,
                                   lane, j, s, codes, arcs)
             : best_walk<BP, false>(bps, row_start, rs16, row_src, row_arc, n_act, s1, b, d,
                                    lane, j, s, codes, arcs);
  }
  if (j == 0) state_out[lane] = s;
}

template <typename BP>
cudaError_t launch_best(const BP* bps, const int* row_start, const int* row_src,
                        const int* row_arc, const int* end_state, const int* num_frames, int t0,
                        int w, int s1, int b, int d, int* codes, int* arcs, int* state_out,
                        cudaStream_t st) {
  static int sms[64];  // multiprocessors, by device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  const int n_sm = dev < 64 ? sms[dev] : 132;
  // lanes a CTA: one CTA an SM holds the row starts, so spread the lanes
  // over the SMs first
  const int lanes = std::min(kBestThreads / 32, std::max(1, (b + n_sm - 1) / n_sm));
  const size_t smem = (static_cast<size_t>(s1) + 1) * sizeof(uint16_t);
  const bool staged = smem <= kBestSmemLimit && reinterpret_cast<uintptr_t>(row_start) % 16 == 0;
  if (staged && smem > 48 * 1024) {
    err = cudaFuncSetAttribute(backtrace_best_kernel<BP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  backtrace_best_kernel<BP><<<(b + lanes - 1) / lanes, kBestThreads, staged ? smem : 0, st>>>(
      bps, row_start, row_src, row_arc, end_state, num_frames, t0, w, s1, b, d, lanes, staged,
      codes, arcs, state_out);
  return cudaGetLastError();
}

__global__ void __launch_bounds__(kThreads)
backtrace_nbest_kernel(const int* __restrict__ bp_arc, const int8_t* __restrict__ bp_slot,
                       int64_t st_t, int64_t st_b, int64_t st_s, int64_t st_k,
                       const int* __restrict__ arc_src, const int* __restrict__ num_frames,
                       const int* __restrict__ state, const int* __restrict__ slot, int b, int c,
                       int t_total, int* __restrict__ arcs, int* __restrict__ state_out,
                       uint8_t* __restrict__ ok_out) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= static_cast<int64_t>(b) * c) return;
  const int lane = static_cast<int>(idx / c);
  const int nf = __ldg(num_frames + lane);
  int s = __ldg(state + idx);
  int k = __ldg(slot + idx);
  bool ok = true;
  for (int t = t_total - 1; t >= 0; --t) {
    int out = -1;
    if (ok && t < nf) {
      const int64_t e = t * st_t + lane * st_b + s * st_s + k * st_k;
      const int a = __ldg(bp_arc + e);
      const int q = __ldg(bp_slot + e);
      if (a < 0) {
        ok = false;
      } else {
        out = a;
        k = q;
        s = __ldg(arc_src + a);
      }
    }
    arcs[static_cast<int64_t>(t) * b * c + idx] = out;
  }
  state_out[idx] = s;
  ok_out[idx] = ok ? 1 : 0;
}

}  // namespace

// bp_bytes: 1 = uint8 codes, 2 = int16.  w may be 0 (the state passes through).
extern "C" int vbt_backtrace_best(const void* bps, int bp_bytes, const int* row_start,
                                  const int* row_src, const int* row_arc, const int* end_state,
                                  const int* num_frames, int t0, int w, int s1, int b, int d,
                                  int* codes, int* arcs, int* state_out, void* stream) {
  if (w < 0 || d < 1 || (bp_bytes != 1 && bp_bytes != 2)) return cudaErrorInvalidValue;
  if (b == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bp_bytes == 1)
    return launch_best(static_cast<const uint8_t*>(bps), row_start, row_src, row_arc, end_state,
                       num_frames, t0, w, s1, b, d, codes, arcs, state_out, st);
  return launch_best(static_cast<const int16_t*>(bps), row_start, row_src, row_arc, end_state,
                     num_frames, t0, w, s1, b, d, codes, arcs, state_out, st);
}

// Strides in elements, shared by bp_arc and bp_slot.
extern "C" int vbt_backtrace_nbest_thread(const int* bp_arc, const int8_t* bp_slot, int64_t st_t,
                                   int64_t st_b, int64_t st_s, int64_t st_k, const int* arc_src,
                                   const int* num_frames, const int* state, const int* slot, int b,
                                   int c, int t_total, int* arcs, int* state_out, uint8_t* ok_out,
                                   void* stream) {
  if (t_total < 0 || c < 0) return cudaErrorInvalidValue;
  const int64_t walks = static_cast<int64_t>(b) * c;
  if (walks == 0) return 0;
  const int64_t grid = (walks + kThreads - 1) / kThreads;
  if (grid > 0x7fffffff) return cudaErrorInvalidValue;
  backtrace_nbest_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      bp_arc, bp_slot, st_t, st_b, st_s, st_k, arc_src, num_frames, state, slot, b, c, t_total,
      arcs, state_out, ok_out);
  return cudaGetLastError();
}
