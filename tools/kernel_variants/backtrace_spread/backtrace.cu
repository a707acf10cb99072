// backtrace_best variant "spread": the same function and C interface as
// voicebridge_tpu_torch/csrc/backtrace.cu, as the thread-per-lane walk that
// came before it (a frame reads the code and row_start[s], then row_src of
// the code: two round trips), launched with one lane in each CTA of 32
// threads instead of 128 lanes in one CTA, so that the lanes spread over the
// SMs.  Timed beside the shipped source by tools/time_viterbi_kernels.py
// (--variant) to part the gain of the launch geometry from that of the
// warp's speculation over the state's slots.

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
  const int lane = blockIdx.x;
  if (threadIdx.x != 0) return;
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
  const unsigned grid = static_cast<unsigned>(b);
  if (bp_bytes == 1)
    backtrace_best_kernel<uint8_t><<<grid, 32, 0, st>>>(
        static_cast<const uint8_t*>(bps), row_start, row_src, row_arc, end_state, num_frames, t0, w,
        s1, b, d, codes, arcs, state_out);
  else
    backtrace_best_kernel<int16_t><<<grid, 32, 0, st>>>(
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
