// Generic Viterbi alignment over per-utterance training graphs for Hopper
// (sm_90a).
//
// Replaces the XLA scans voicebridge_tpu/ops/viterbi.py
// (viterbi_forward_batched with _tree_reduce_max and _prune, and
// backtrace_batched_device), used when a set of training graphs does not fit
// the banded form of K4.  Every utterance has its own padded graph
// arc_* [B, A]; per utterance b, frame t < nf[b] and state s, over the arcs j
// entering s:
//
//   c_j        = (alpha[src_j] + score_j) + fl(ll[b, t, pdf_j] * acwt)
//   v[s]       = max(NEG_INF, max_j c_j)
//   bps[t,b,s] = the lowest arc id among the maximal c_j (-1 if v <= NEG_INF/2)
//   alpha'[s]  = v[s] if v[s] >= max_s v[s] - beam else NEG_INF
//
// and alpha_end[b] is alpha after the utterance's last frame (alpha0 when it
// has none); frames past the end write bps -1.  The backtrace takes the end
// state as the first argmax of alpha_end + final and walks
// s <- src[bps[t, b, s]]; a -1 on the path clears ok.
//
// Ties: the JAX package reduces through a gather tree over the arcs sorted
// stably by destination and takes the first maximal slot at each level,
// which is the lowest arc id among equals.  The caller hands the same
// grouping as a CSR (in_start, in_arc: ascending arc ids within a
// destination) and a thread walks it with a strict >.
//
// What bounds it on the H100: the chain of T dependent frames, as in K4, not
// bytes or FLOPs (a few thousand arcs per utterance).  Design: ONE launch for
// the sub-batch, one CTA per utterance, alpha double-buffered in shared
// memory, a thread per state over its in-arcs, the beam's block-wide max by
// warp shuffles, two __syncthreads per frame.  The arcs (source, score, pdf,
// in CSR order) are staged in shared memory when they fit in 96 KB with the
// rest, else read through L2.  Shared memory beyond 48 KB is taken by
// opt-in; a graph whose alpha does not fit in 227 KB is refused, not run
// another way.  The adds and the multiply use __fadd_rn / __fmul_rn in the
// JAX order, so equal inputs give bit-equal scores and equal backpointers as
// the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1.0e30f;
constexpr int kMaxThreads = 512;
constexpr size_t kSmemArcLimit = 96 * 1024;  // two CTAs per SM at most this
constexpr size_t kSmemMax = 227 * 1024;
constexpr int kWarpsPerBlock = 4;

template <bool kArcsShared>
__global__ void __launch_bounds__(kMaxThreads)
generic_forward_kernel(const int* __restrict__ arc_src, const int* __restrict__ arc_pdf,
                       const float* __restrict__ arc_score,
                       const int* __restrict__ in_start, const int* __restrict__ in_arc,
                       const float* __restrict__ alpha0, const float* __restrict__ ll,
                       const int* __restrict__ num_frames, float acwt, float beam,
                       int b_total, int s, int a, int t_total, int p,
                       float* __restrict__ alpha_end, int* __restrict__ bps) {
  extern __shared__ float smem[];
  float* a_cur = smem;
  float* a_nxt = smem + s;
  float* red = smem + 2 * s;  // one slot per warp
  int* start_s = reinterpret_cast<int*>(red + 32);
  int* src_s = start_s + s + 1;
  float* w_s = reinterpret_cast<float*>(src_s + a);
  int* pdf_s = reinterpret_cast<int*>(w_s + a);
  const int b = blockIdx.x;
  const int64_t row = static_cast<int64_t>(b) * s;
  const int64_t arow = static_cast<int64_t>(b) * a;
  const int* in_arc_b = in_arc + arow;
  const int nf = num_frames[b];
  for (int i = threadIdx.x; i < s; i += blockDim.x) {
    const float a0 = alpha0[row + i];
    a_cur[i] = a0;
    alpha_end[row + i] = nf == 0 ? a0 : kNeg;
  }
  for (int i = threadIdx.x; i <= s; i += blockDim.x)
    start_s[i] = in_start[static_cast<int64_t>(b) * (s + 1) + i];
  if (kArcsShared) {
    for (int j = threadIdx.x; j < a; j += blockDim.x) {
      const int64_t arc = arow + in_arc_b[j];
      src_s[j] = arc_src[arc];
      w_s[j] = arc_score[arc];
      pdf_s[j] = arc_pdf[arc];
    }
  }
  const float* ll_b = ll + static_cast<int64_t>(b) * t_total * p;
  const int warp = threadIdx.x / 32;
  const int num_warps = (blockDim.x + 31) / 32;
  __syncthreads();

  for (int t = 0; t < t_total; ++t) {
    int* bp_t = bps + (static_cast<int64_t>(t) * b_total + b) * s;
    if (t >= nf) {  // the whole CTA shares nf
      for (int st = threadIdx.x; st < s; st += blockDim.x) bp_t[st] = -1;
      continue;
    }
    const float* ll_t = ll_b + static_cast<int64_t>(t) * p;
    float lmax = kNeg;
    for (int st = threadIdx.x; st < s; st += blockDim.x) {
      float best = kNeg;
      int win = -1;
      const int j1 = start_s[st + 1];
      for (int j = start_s[st]; j < j1; ++j) {
        int src, pdf;
        float w;
        if (kArcsShared) {
          src = src_s[j];
          w = w_s[j];
          pdf = pdf_s[j];
        } else {
          const int64_t arc = arow + in_arc_b[j];
          src = arc_src[arc];
          w = arc_score[arc];
          pdf = arc_pdf[arc];
        }
        const float c = __fadd_rn(__fadd_rn(a_cur[src], w), __fmul_rn(ll_t[pdf], acwt));
        if (c > best) {
          best = c;
          win = j;
        }
      }
      bp_t[st] = best > 0.5f * kNeg ? in_arc_b[win] : -1;
      a_nxt[st] = best;
      lmax = fmaxf(lmax, best);
    }
    for (int delta = 16; delta > 0; delta /= 2)
      lmax = fmaxf(lmax, __shfl_xor_sync(0xffffffffu, lmax, delta));
    if (threadIdx.x % 32 == 0) red[warp] = lmax;
    __syncthreads();
    float top = red[0];
    for (int i = 1; i < num_warps; ++i) top = fmaxf(top, red[i]);
    const float thresh = __fsub_rn(top, beam);
    for (int st = threadIdx.x; st < s; st += blockDim.x) {
      float v = a_nxt[st];
      if (!(v >= thresh)) v = kNeg;
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
generic_backtrace_kernel(const int* __restrict__ arc_src, const float* __restrict__ alpha_end,
                         const float* __restrict__ final_score, const int* __restrict__ bps,
                         const int* __restrict__ num_frames, int b_total, int s, int a,
                         int t_total, int* __restrict__ arcs, uint8_t* __restrict__ ok_out,
                         int* __restrict__ end_state, float* __restrict__ score_out) {
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
  const int* src_b = arc_src + static_cast<int64_t>(b) * a;
  int st = arg;
  for (int t = t_total - 1; t >= 0; --t) {
    int arc = -1;
    if (t < nf) {
      arc = bps[(static_cast<int64_t>(t) * b_total + b) * s + st];
      if (arc >= 0)
        st = src_b[arc];
      else
        ok = false;
    }
    arcs[static_cast<int64_t>(t) * b_total + b] = arc;
  }
  ok_out[b] = ok ? 1 : 0;
}

template <bool kArcsShared>
cudaError_t launch_forward(size_t bytes, int threads, cudaStream_t st, const int* arc_src,
                           const int* arc_pdf, const float* arc_score, const int* in_start,
                           const int* in_arc, const float* alpha0, const float* ll,
                           const int* num_frames, float acwt, float beam, int b, int s, int a,
                           int t, int p, float* alpha_end, int* bps) {
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        generic_forward_kernel<kArcsShared>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
  }
  generic_forward_kernel<kArcsShared><<<b, threads, bytes, st>>>(
      arc_src, arc_pdf, arc_score, in_start, in_arc, alpha0, ll, num_frames, acwt, beam, b, s,
      a, t, p, alpha_end, bps);
  return cudaGetLastError();
}

}  // namespace

extern "C" int vbt_generic_forward(const int* arc_src, const int* arc_pdf,
                                   const float* arc_score, const int* in_start,
                                   const int* in_arc, const float* alpha0, const float* ll,
                                   const int* num_frames, float acwt, float beam, int b, int s,
                                   int a, int t, int p, float* alpha_end, int* bps,
                                   void* stream) {
  if (b == 0 || s == 0) return 0;
  const int threads = s >= kMaxThreads ? kMaxThreads : ((s + 31) / 32) * 32;
  const size_t base = sizeof(float) * (3 * static_cast<size_t>(s) + 33);
  const size_t with_arcs = base + 12 * static_cast<size_t>(a);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (with_arcs <= kSmemArcLimit)
    return launch_forward<true>(with_arcs, threads, st, arc_src, arc_pdf, arc_score, in_start,
                                in_arc, alpha0, ll, num_frames, acwt, beam, b, s, a, t, p,
                                alpha_end, bps);
  if (base > kSmemMax) return cudaErrorInvalidValue;
  return launch_forward<false>(base, threads, st, arc_src, arc_pdf, arc_score, in_start,
                               in_arc, alpha0, ll, num_frames, acwt, beam, b, s, a, t, p,
                               alpha_end, bps);
}

extern "C" int vbt_generic_backtrace(const int* arc_src, const float* alpha_end,
                                     const float* final_score, const int* bps,
                                     const int* num_frames, int b, int s, int a, int t,
                                     int* arcs, uint8_t* ok, int* end_state, float* score,
                                     void* stream) {
  if (b == 0 || s == 0) return 0;
  const int blocks = (b + kWarpsPerBlock - 1) / kWarpsPerBlock;
  generic_backtrace_kernel<<<blocks, kWarpsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      arc_src, alpha_end, final_score, bps, num_frames, b, s, a, t, arcs, ok, end_state, score);
  return cudaGetLastError();
}
