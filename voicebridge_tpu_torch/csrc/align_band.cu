// K4: banded Viterbi alignment over training graphs for Hopper (sm_90a).
//
// Replaces the XLA scans voicebridge_tpu/ops/align_band.py
// (viterbi_forward_banded and backtrace_banded_device).  States of every
// utterance's training graph are renumbered by BFS so that each arc's
// displacement dst - src is one of K band offsets, and all arcs entering a
// state share the state's pdf.  Per utterance b, frame t and state s:
//
//   cand_k    = alpha[s - off_k] + W[b, s, k]        (NEG_INF out of range)
//   bps[t,b,s] = first k with the largest cand_k
//   alpha'[s] = max_k cand_k + fl(ll[b, t, pdf[b, s]] * acwt)   if t < nf[b]
//
// and alpha_end[b] is alpha after the utterance's last frame (alpha0 when it
// has none).  The backtrace takes the end state as the first argmax of
// alpha_end + final and walks s <- s - off[bps[t, b, s]], resolving each
// band slot to the original arc id; an empty slot on the path clears ok.
//
// What bounds it on the H100: not bytes or FLOPs (S x K adds per frame, a
// few KB per utterance) but the chain of T dependent frames.  The XLA
// program ran one scan step per frame; a kernel launch per frame would pay
// a few microseconds of launch latency T times.  Design: ONE launch for the
// whole sub-batch, one CTA per utterance, which keeps alpha double-buffered
// in shared memory and loops over all T frames with one __syncthreads per
// frame.  W (S x K floats) and the state pdfs live in shared memory when they
// fit, else W is read through L2.  The only global traffic per frame is one
// gathered loglik per state and S bytes of backpointers.  The adds and the
// multiply use __fadd_rn / __fmul_rn (no FMA contraction), in the JAX
// package's order (shift + W, max, + emission), so equal inputs give
// bit-equal scores and equal slot choices as the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1.0e30f;
constexpr int kMaxThreads = 512;
constexpr size_t kSmemWLimit = 96 * 1024;  // two CTAs per SM at most this
constexpr int kWarpsPerBlock = 4;

template <bool kWShared>
__global__ void __launch_bounds__(kMaxThreads)
align_forward_kernel(const float* __restrict__ W, const int* __restrict__ pdf,
                     const float* __restrict__ alpha0, const float* __restrict__ ll,
                     const int* __restrict__ num_frames, const int* __restrict__ offsets,
                     float acwt, int b_total, int s, int k, int t_total, int p,
                     float* __restrict__ alpha_end, uint8_t* __restrict__ bps) {
  extern __shared__ float smem[];
  float* a_cur = smem;
  float* a_nxt = smem + s;
  int* pdf_s = reinterpret_cast<int*>(smem + 2 * s);
  int* off_s = pdf_s + s;
  float* w_s = reinterpret_cast<float*>(off_s + k);
  const int b = blockIdx.x;
  const int64_t row = static_cast<int64_t>(b) * s;
  const float* w_b = W + row * k;
  const int nf = num_frames[b];
  for (int i = threadIdx.x; i < s; i += blockDim.x) {
    const float a0 = alpha0[row + i];
    a_cur[i] = a0;
    pdf_s[i] = pdf[row + i];
    alpha_end[row + i] = nf == 0 ? a0 : kNeg;
  }
  for (int i = threadIdx.x; i < k; i += blockDim.x) off_s[i] = offsets[i];
  if (kWShared)
    for (int i = threadIdx.x; i < s * k; i += blockDim.x) w_s[i] = w_b[i];
  const float* w_src = kWShared ? w_s : w_b;
  const float* ll_b = ll + static_cast<int64_t>(b) * t_total * p;
  __syncthreads();

  for (int t = 0; t < t_total; ++t) {
    const float* ll_t = ll_b + static_cast<int64_t>(t) * p;
    uint8_t* bp_t = bps + (static_cast<int64_t>(t) * b_total + b) * s;
    const bool active = t < nf;
    for (int st = threadIdx.x; st < s; st += blockDim.x) {
      const float e = __fmul_rn(ll_t[pdf_s[st]], acwt);
      const float* w_st = w_src + static_cast<int64_t>(st) * k;
      float best = 0.f;
      int slot = 0;
      for (int kk = 0; kk < k; ++kk) {
        const int src = st - off_s[kk];
        const float a = (src >= 0 && src < s) ? a_cur[src] : kNeg;
        const float c = __fadd_rn(a, w_st[kk]);
        if (kk == 0 || c > best) {
          best = c;
          slot = kk;
        }
      }
      bp_t[st] = static_cast<uint8_t>(slot);
      const float v = active ? __fadd_rn(best, e) : a_cur[st];
      a_nxt[st] = v;
      if (t + 1 == nf) alpha_end[row + st] = v;
    }
    __syncthreads();
    float* tmp = a_cur;
    a_cur = a_nxt;
    a_nxt = tmp;
  }
}

// One warp per utterance: the end state by a warp argmax (first maximal
// index), then lane 0 walks the T frames back.
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
align_backtrace_kernel(const float* __restrict__ alpha_end,
                       const float* __restrict__ final_score,
                       const uint8_t* __restrict__ bps, const int* __restrict__ num_frames,
                       const int* __restrict__ offsets, const int* __restrict__ arc_of,
                       int b_total, int s, int k, int t_total, int* __restrict__ arcs,
                       int* __restrict__ end_state, uint8_t* __restrict__ ok_out,
                       float* __restrict__ score_out) {
  const int b = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (b >= b_total) return;
  const int64_t row = static_cast<int64_t>(b) * s;
  float best = -__int_as_float(0x7f800000);  // -inf
  int arg = s;
  for (int i = lane; i < s; i += 32) {
    const float v = __fadd_rn(alpha_end[row + i], final_score[row + i]);
    if (v > best) {
      best = v;
      arg = i;
    }
  }
  for (int delta = 16; delta > 0; delta /= 2) {
    const float ov = __shfl_down_sync(0xffffffffu, best, delta);
    const int oi = __shfl_down_sync(0xffffffffu, arg, delta);
    if (ov > best || (ov == best && oi < arg)) {
      best = ov;
      arg = oi;
    }
  }
  if (lane != 0) return;
  bool ok = best > 0.5f * kNeg;
  score_out[b] = best;
  end_state[b] = arg;
  const int nf = num_frames[b];
  int st = arg;
  for (int t = t_total - 1; t >= 0; --t) {
    int a = -1;
    if (t < nf) {
      const int slot = bps[(static_cast<int64_t>(t) * b_total + b) * s + st];
      a = arc_of[(row + st) * k + slot];
      if (a >= 0)
        st -= offsets[slot];
      else
        ok = false;
    }
    arcs[static_cast<int64_t>(t) * b_total + b] = a;
  }
  ok_out[b] = ok ? 1 : 0;
}

}  // namespace

extern "C" int vbt_align_forward(const float* W, const int* pdf, const float* alpha0,
                                 const float* ll, const int* num_frames, const int* offsets,
                                 float acwt, int b, int s, int k, int t, int p,
                                 float* alpha_end, uint8_t* bps, void* stream) {
  if (b == 0 || s == 0) return 0;
  if (k < 1 || k > 255) return cudaErrorInvalidValue;
  const int threads = s >= kMaxThreads ? kMaxThreads : ((s + 31) / 32) * 32;
  const size_t base = sizeof(float) * (3 * static_cast<size_t>(s) + k);
  const size_t with_w = base + sizeof(float) * static_cast<size_t>(s) * k;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (with_w <= kSmemWLimit) {
    if (with_w > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          align_forward_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(with_w));
      if (err != cudaSuccess) return err;
    }
    align_forward_kernel<true><<<b, threads, with_w, st>>>(
        W, pdf, alpha0, ll, num_frames, offsets, acwt, b, s, k, t, p, alpha_end, bps);
  } else {
    if (base > 227 * 1024) return cudaErrorInvalidValue;
    if (base > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          align_forward_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(base));
      if (err != cudaSuccess) return err;
    }
    align_forward_kernel<false><<<b, threads, base, st>>>(
        W, pdf, alpha0, ll, num_frames, offsets, acwt, b, s, k, t, p, alpha_end, bps);
  }
  return cudaGetLastError();
}

extern "C" int vbt_align_backtrace(const float* alpha_end, const float* final_score,
                                   const uint8_t* bps, const int* num_frames,
                                   const int* offsets, const int* arc_of, int b, int s,
                                   int k, int t, int* arcs, int* end_state, uint8_t* ok,
                                   float* score, void* stream) {
  if (b == 0 || s == 0) return 0;
  const int blocks = (b + kWarpsPerBlock - 1) / kWarpsPerBlock;
  align_backtrace_kernel<<<blocks, kWarpsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      alpha_end, final_score, bps, num_frames, offsets, arc_of, b, s, k, t, arcs, end_state, ok,
      score);
  return cudaGetLastError();
}
