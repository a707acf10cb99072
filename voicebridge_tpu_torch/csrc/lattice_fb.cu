// K5: one frame of the lattice forward-backward's recompute-and-test step
// for Hopper (sm_90a).
//
// Replaces the per-frame step ``fwd_frame`` of the XLA scan in
// voicebridge_tpu/ops/lattice.py (_fb_win_backward).  For forward-plan state
// s and utterance lane b, over the state's in-degree rows
// r in [row_start[s], row_start[s+1]):
//
//   g[r,k]       = alpha[row_src[r,k], b] + row_w[r,k]
//   am[r]        = ll_t[row_pdf[r], b] * acwt
//   alpha'[s, b] = t < nf[b] ? max_r (max_k g[r,k] + am[r]) : alpha[s, b]
//   tail[r]      = am[r] + beta_next[row_dst[r], b]
//   bit k of words[r, b] = g[r,k] + tail[r] >= thresh[b] && t < nf[b]
//
// alpha is in forward-plan space; beta_next (beta above frame t, with the
// final scores where the utterance ends at t + 1) is in backward-plan space,
// and row_dst maps each forward row's destination there.  The recomputed
// alpha is the Viterbi forward of the same frame (K3's value), so a window
// replays its forward from the phase-1 snapshot while it tests every arc
// instance against the lattice beam.
//
// What bounds it on the H100: K3's gathers (alpha rows of every arc source,
// about 4 bytes x B x arcs per frame from an (S+1) x B table resident in the
// 50 MB L2), plus one beta read per thread and one survivor byte written per
// row and lane (R x B bytes per frame), and launch latency per frame.
//
// Design: one thread per (state, lane) with the lane fastest, as K3: a warp
// reads a row's indices as a broadcast and gathers contiguous alpha, loglik
// and beta segments, and writes its rows' survivor bytes coalesced.  All
// rows of a state share its destination, so the beta gather is one read per
// thread.  The arithmetic uses __fadd_rn/__fmul_rn in the JAX order,
// (alpha + w) + ((ll * acwt) + beta), so no FMA contraction changes the
// rounding: the survivor bits equal the plain version's and the recomputed
// alpha equals the phase-1 snapshot bit for bit.  One byte holds the D <= 8
// slots of a row (bit k = slot k).  Offsets that scale with B, R or D are
// 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
lattice_fb_kernel(const float* __restrict__ alpha, float* __restrict__ alpha_out,
                  uint8_t* __restrict__ words, const float* __restrict__ ll_t,
                  const float* __restrict__ beta_next, const float* __restrict__ thresh,
                  const int* __restrict__ row_start, const int* __restrict__ row_src,
                  const float* __restrict__ row_w, const int* __restrict__ row_pdf,
                  const int* __restrict__ row_dst, const int* __restrict__ num_frames,
                  int t, float acwt, int s1, int b, int d) {
  const int64_t gid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (gid >= static_cast<int64_t>(s1) * b) return;
  const int s = static_cast<int>(gid / b);
  const int lane = static_cast<int>(gid - static_cast<int64_t>(s) * b);
  const int r0 = row_start[s];
  const int r1 = row_start[s + 1];
  const bool active = t < num_frames[lane];
  const float th = thresh[lane];
  const float beta =
      r1 > r0 ? beta_next[static_cast<int64_t>(row_dst[r0]) * b + lane] : 0.f;
  float best = 0.f;
  for (int r = r0; r < r1; ++r) {
    const int64_t base = static_cast<int64_t>(r) * d;
    const float am = __fmul_rn(ll_t[static_cast<int64_t>(row_pdf[r]) * b + lane], acwt);
    const float tail = __fadd_rn(am, beta);
    float mx = 0.f;
    unsigned word = 0;
    for (int k = 0; k < d; ++k) {
      const float g = __fadd_rn(
          alpha[static_cast<int64_t>(row_src[base + k]) * b + lane], row_w[base + k]);
      if (k == 0 || g > mx) mx = g;
      if (active && __fadd_rn(g, tail) >= th) word |= 1u << k;
    }
    const float v = __fadd_rn(mx, am);
    if (r == r0 || v > best) best = v;
    words[static_cast<int64_t>(r) * b + lane] = static_cast<uint8_t>(word);
  }
  alpha_out[gid] = active ? best : alpha[gid];
}

}  // namespace

extern "C" int vbt_lattice_fb(const float* alpha, float* alpha_out, uint8_t* words,
                              const float* ll_t, const float* beta_next,
                              const float* thresh, const int* row_start,
                              const int* row_src, const float* row_w, const int* row_pdf,
                              const int* row_dst, const int* num_frames, int t,
                              float acwt, int s1, int b, int d, void* stream) {
  if (d < 1 || d > 8) return cudaErrorInvalidValue;
  const int64_t blocks = (static_cast<int64_t>(s1) * b + kThreads - 1) / kThreads;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  lattice_fb_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      alpha, alpha_out, words, ll_t, beta_next, thresh, row_start, row_src, row_w,
      row_pdf, row_dst, num_frames, t, acwt, s1, b, d);
  return cudaGetLastError();
}
