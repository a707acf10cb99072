// The best-path and N-best backtraces for Hopper (sm_90a), one launch each.
//
// backtrace_best replaces the XLA scan of voicebridge_tpu/ops/decode_core.py
// (backtrace_scan, its lax.scan over a block's frames).  For lane b, from
// end_state[b] at the block's last frame down to its first:
//
//   code      = row_start[s] * D + bps[i, s, b]      (the winner's global slot)
//   codes[i,b] = code, arcs[i,b] = row_arc[code]     (-1 at frames t0+i >= nf[b])
//   s         = row_src[code]                        (only on active frames)
//
// and the state at the block's start.  A pad slot's row_arc is -1, which the
// host reads as "no path", as the plain version does.
//
// backtrace_nbest serves the port's backtrace_nbest_device; it has no TPU
// counterpart: the JAX package's backtrace_nbest (voicebridge_tpu/ops/
// viterbi.py) is host numpy over copies of the whole tables.  For lane b and
// candidate c, from the end entry (state, slot) down from frame nf[b] - 1:
//
//   a = bp_arc[t, b, s, k]; a < 0: the walk fails and stops;
//   else arcs[t, b, c] = a, k = bp_slot[t, b, s, k], s = arc_src[a]
//
// with -1 at every frame the walk does not step (past the lane's end, at and
// below a failure).  The tables are read through their strides, so K7's
// lane-minor [T, S, B, K] tables serve as the [T, B, S, K] views the caller
// holds.
//
// What bounds them on the H100: neither bytes nor operations.  A walk moves
// a few bytes a frame (about 2.7 MB for 128 lanes x 1000 frames of the best
// path: 0.8 us at 3.35 TB/s), but its frames form a chain of dependent
// loads: the backpointer at (t, s) is a DRAM read at a state known only after
// the frame above, and the next state one L2 read after it (row_src, or
// arc_src).  So one frame costs a DRAM plus an L2 latency, about 1 us, and
// 1000 frames about 1 ms, however many lanes run beside each other.
//
// Design: a thread per walk (lane, or lane and candidate), all walks of a
// block or batch in one launch, so that their chains overlap.  Within a
// frame the independent reads are issued together: the backpointer and
// row_start[s] (best path), the arc and the slot (N-best), then row_src and
// row_arc of the code.  Read-only inputs go through the read-only cache.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

template <typename BP>
__global__ void __launch_bounds__(kThreads)
backtrace_best_kernel(const BP* __restrict__ bps, const int* __restrict__ row_start,
                      const int* __restrict__ row_src, const int* __restrict__ row_arc,
                      const int* __restrict__ end_state, const int* __restrict__ num_frames,
                      int t0, int w, int s1, int b, int d, int* __restrict__ codes,
                      int* __restrict__ arcs, int* __restrict__ state_out) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= b) return;
  const int nf = __ldg(num_frames + lane);
  int s = __ldg(end_state + lane);
  for (int i = w - 1; i >= 0; --i) {
    const int64_t at = static_cast<int64_t>(i) * b + lane;
    if (t0 + i < nf) {
      const int64_t bp_at = (static_cast<int64_t>(i) * s1 + s) * b + lane;
      const int code = static_cast<int>(__ldg(bps + bp_at));
      const int64_t g = static_cast<int64_t>(__ldg(row_start + s)) * d + code;
      codes[at] = static_cast<int>(g);
      arcs[at] = __ldg(row_arc + g);
      s = __ldg(row_src + g);
    } else {
      codes[at] = -1;
      arcs[at] = -1;
    }
  }
  state_out[lane] = s;
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
  const unsigned grid = static_cast<unsigned>((b + kThreads - 1) / kThreads);
  if (bp_bytes == 1)
    backtrace_best_kernel<uint8_t><<<grid, kThreads, 0, st>>>(
        static_cast<const uint8_t*>(bps), row_start, row_src, row_arc, end_state, num_frames, t0, w,
        s1, b, d, codes, arcs, state_out);
  else
    backtrace_best_kernel<int16_t><<<grid, kThreads, 0, st>>>(
        static_cast<const int16_t*>(bps), row_start, row_src, row_arc, end_state, num_frames, t0,
        w, s1, b, d, codes, arcs, state_out);
  return cudaGetLastError();
}

// Strides in elements, shared by bp_arc and bp_slot.
extern "C" int vbt_backtrace_nbest(const int* bp_arc, const int8_t* bp_slot, int64_t st_t,
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
