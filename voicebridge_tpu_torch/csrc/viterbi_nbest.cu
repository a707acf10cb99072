// K7: one frame of the exact N-best Viterbi relaxation for Hopper (sm_90a).
//
// Replaces the per-frame step of the XLA scan in
// voicebridge_tpu/ops/viterbi.py (viterbi_nbest_forward -> one_step and
// _nbest_reduce).  Every state of a shared graph carries its K best
// partial-path scores, best first.  For utterance lane b and state s, over
// the arcs j entering s (grouped by destination, ascending arc id) and the
// source's slots q:
//
//   cand(j, q)    = alpha[b, src[j], q] + (score[j] + fl(ll_t[b, pdf[j]] * acwt))
//   top K of cand -> alpha'[b, s, :], bp_arc[b, s, :] = arc id, bp_slot = q
//   best[b]       = max over states of alpha'[b, s, 0]
//   alpha'[b,s,k] = NEG_INF where alpha'[b, s, k] < best[b] - beam
//
// Ties: the JAX package takes top_k at every level of a reduction tree over
// the destination-sorted arcs, which orders equal values by (position in
// that arc list, source slot).  Here a thread meets the candidates in just
// that order and inserts with a strict >, so an earlier candidate stays
// ahead of a later equal one.  A slot that holds NEG_INF (no candidate, or
// pruned by the beam) carries arc -1 and slot 0.  Frames at or past an
// utterance's length keep the old alpha and write arc -1; the frame that
// ends an utterance writes alpha_end.
//
// What bounds it on the H100: bytes.  A frame reads K floats per arc and
// lane (gathers of K contiguous floats from an alpha table that mostly stays
// in the 50 MB L2) and writes 9 bytes per (lane, state, slot): score, arc
// and slot.  The beam needs each lane's maximum over all states before any
// score can be pruned, so a frame is two kernels: the relaxation, which
// leaves the raw scores in alpha_out and folds its block's best into
// best[b] with one atomic max per block, and a second elementwise pass that
// prunes, applies the frame mask and captures alpha_end.
//
// Design: one thread per (lane, state) with the state fastest, so a warp
// reads consecutive CSR offsets and writes consecutive output lists.  The
// TPU's fixed-width gather tree is not carried over: a thread walks its
// state's in-arcs and keeps the list in registers (KMAX slots, the first K
// are written), sorted by an unrolled insertion.  Source lists are sorted,
// so a source's remaining slots are skipped once one fails to enter.  The
// adds and the multiply use __fadd_rn / __fmul_rn in the JAX order, so equal
// inputs give bit-equal scores and equal provenance as the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1.0e30f;
constexpr int kThreads = 128;

// max for floats that may be negative, through the integer atomics
__device__ __forceinline__ void atomic_max_float(float* addr, float v) {
  if (v >= 0.f)
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  else
    atomicMin(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
}

__global__ void nbest_init_best(float* __restrict__ best, int b) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < b) best[i] = kNeg;
}

template <int KMAX>
__global__ void __launch_bounds__(kThreads)
nbest_relax_kernel(const float* __restrict__ alpha, float* __restrict__ raw,
                   int* __restrict__ bp_arc, int8_t* __restrict__ bp_slot,
                   float* __restrict__ best, const float* __restrict__ ll_t,
                   int64_t ll_stride, const int* __restrict__ in_start,
                   const int* __restrict__ src, const int* __restrict__ pdf,
                   const float* __restrict__ score, const int* __restrict__ arc,
                   const int* __restrict__ num_frames, int t, float acwt, int s_total,
                   int k) {
  const int b = blockIdx.y;
  const int s = blockIdx.x * kThreads + threadIdx.x;
  const bool active = t < num_frames[b];
  float top = kNeg;
  if (s < s_total) {
    const int64_t lane0 = static_cast<int64_t>(b) * s_total;
    const int64_t out = (lane0 + s) * k;
    if (!active) {
      for (int q = 0; q < k; ++q) {
        raw[out + q] = alpha[out + q];
        bp_arc[out + q] = -1;
        bp_slot[out + q] = 0;
      }
    } else {
      float v[KMAX];
      int va[KMAX];
      int vq[KMAX];
#pragma unroll
      for (int i = 0; i < KMAX; ++i) {
        v[i] = kNeg;
        va[i] = -1;
        vq[i] = 0;
      }
      const float* ll_b = ll_t + static_cast<int64_t>(b) * ll_stride;
      const int j1 = in_start[s + 1];
      for (int j = in_start[s]; j < j1; ++j) {
        const float* ap = alpha + (lane0 + src[j]) * k;
        if (!(ap[0] > kNeg)) continue;  // the source holds no hypothesis
        const float w = __fadd_rn(score[j], __fmul_rn(ll_b[pdf[j]], acwt));
        for (int q = 0; q < k; ++q) {
          const float c = __fadd_rn(ap[q], w);
          if (!(c > v[KMAX - 1])) break;  // nor will the source's later slots
          v[KMAX - 1] = c;
          va[KMAX - 1] = j;
          vq[KMAX - 1] = q;
#pragma unroll
          for (int i = KMAX - 1; i > 0; --i) {
            if (v[i] > v[i - 1]) {
              const float tv = v[i];
              v[i] = v[i - 1];
              v[i - 1] = tv;
              const int ta = va[i];
              va[i] = va[i - 1];
              va[i - 1] = ta;
              const int tq = vq[i];
              vq[i] = vq[i - 1];
              vq[i - 1] = tq;
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < KMAX; ++i) {
        if (i < k) {
          raw[out + i] = v[i];
          bp_arc[out + i] = va[i] < 0 ? -1 : arc[va[i]];
          bp_slot[out + i] = static_cast<int8_t>(vq[i]);
        }
      }
      top = v[0];
    }
  }
  if (!active) return;  // the whole block shares the lane
  for (int delta = 16; delta > 0; delta /= 2)
    top = fmaxf(top, __shfl_xor_sync(0xffffffffu, top, delta));
  __shared__ float warp_top[kThreads / 32];
  if (threadIdx.x % 32 == 0) warp_top[threadIdx.x / 32] = top;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = warp_top[0];
    for (int i = 1; i < kThreads / 32; ++i) m = fmaxf(m, warp_top[i]);
    if (m > kNeg) atomic_max_float(best + b, m);
  }
}

__global__ void __launch_bounds__(256)
nbest_finish_kernel(float* __restrict__ alpha_out, float* __restrict__ alpha_end,
                    int* __restrict__ bp_arc, int8_t* __restrict__ bp_slot,
                    const float* __restrict__ best, const int* __restrict__ num_frames,
                    int t, float beam, int64_t per_lane, int64_t total) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= total) return;
  const int b = static_cast<int>(i / per_lane);
  const int nf = num_frames[b];
  float x = alpha_out[i];
  if (t < nf && x > kNeg && !(x >= __fsub_rn(best[b], beam))) {
    x = kNeg;
    alpha_out[i] = x;
    bp_arc[i] = -1;
    bp_slot[i] = 0;
  }
  if (t + 1 == nf) alpha_end[i] = x;
}

}  // namespace

extern "C" int vbt_viterbi_nbest(const float* alpha, float* alpha_out, float* alpha_end,
                                 int* bp_arc, int8_t* bp_slot, float* best,
                                 const float* ll_t, int64_t ll_stride, const int* in_start,
                                 const int* src, const int* pdf, const float* score,
                                 const int* arc, const int* num_frames, int t, float acwt,
                                 float beam, int b, int s, int k, void* stream) {
  if (b == 0 || s == 0) return 0;
  if (k < 1 || k > 16 || b > 65535) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  nbest_init_best<<<(b + 255) / 256, 256, 0, st>>>(best, b);
  const dim3 grid((s + kThreads - 1) / kThreads, b);
#define VBT_NBEST_RELAX(KM)                                                              \
  nbest_relax_kernel<KM><<<grid, kThreads, 0, st>>>(alpha, alpha_out, bp_arc, bp_slot,   \
                                                    best, ll_t, ll_stride, in_start, src, \
                                                    pdf, score, arc, num_frames, t, acwt, \
                                                    s, k)
  if (k <= 4)
    VBT_NBEST_RELAX(4);
  else if (k <= 8)
    VBT_NBEST_RELAX(8);
  else
    VBT_NBEST_RELAX(16);
#undef VBT_NBEST_RELAX
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t per_lane = static_cast<int64_t>(s) * k;
  const int64_t total = per_lane * b;
  const int64_t blocks = (total + 255) / 256;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  nbest_finish_kernel<<<static_cast<unsigned>(blocks), 256, 0, st>>>(
      alpha_out, alpha_end, bp_arc, bp_slot, best, num_frames, t, beam, per_lane, total);
  return cudaGetLastError();
}
