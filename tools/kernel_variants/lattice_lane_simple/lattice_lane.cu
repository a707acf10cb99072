// Variant "simple": the first lane-major lattice forward-backward, kept as
// it was before the lanes-minor redesign of voicebridge_tpu_torch/csrc/
// lattice_lane.cu (scores lane-major [B, S], log-likelihoods [B, T, P], two
// kernels a frame and pass).  Its C interface is the earlier one, so it is
// timed through the earlier package: unpack that commit under _archive/ and
// run tools/smoke_phase20.py --tree on it beside this checkout.
//
// The lane-major lattice forward-backward for Hopper (sm_90a).
//
// Replaces the XLA program voicebridge_tpu/ops/lattice.py
// lattice_forward_backward (with _window_fb): two arc-parallel max-plus
// passes over a shared graph, scores [B, S] lane-major (one row of S states
// a lane), log-likelihoods [B, T, P].  Per lane b and frame t:
//
//   forward   score[a] = (alpha[src a] + w a) + fl(ll[b, t, pdf a] * acwt)
//             alpha'[d] = max over arcs a into d of score[a]   (NEG_INF if none)
//             then the prune: alpha'[d] kept if >= best - beam and, with
//             max_active, >= the max_active-th largest kept score (every
//             state tied at that value survives), else NEG_INF; lanes with
//             t >= nf keep alpha; alpha_at_end is alpha after frame nf - 1.
//   backward  beta_eff = (t + 1 == nf) ? final_eff : beta
//             tail[a]  = (fl(ll * acwt) + w a) + beta_eff[dst a]
//             keep[a]  = alpha_t[src a] + tail[a] >= total_best - lattice_beam
//                        and t < nf
//             beta'[s] = max over arcs a out of s of tail[a]  (NEG_INF if none)
//             lanes with t >= nf keep beta.
//
// Adds and the multiply are __fadd_rn / __fmul_rn in the JAX package's order,
// so the kernels give the plain version's scores and survivor bits exactly.
//
// A simple design, one frame a launch: per frame of the forward pass
// lane_relax_kernel (a thread per (lane, state) walking the state's in-arcs,
// a CSR by destination) and lane_prune_kernel (a CTA per lane: the best
// score by a block reduction, then, with max_active, an exact radix select
// of the k-th largest score over the float bits, 8 bits a pass, histograms
// in shared memory); per frame of the backward pass lane_bits_kernel (a
// thread per 8 consecutive arcs of a lane, so that it writes one whole byte
// of the packed survivor mask in np.packbits order, without atomics) and
// lane_beta_kernel (a thread per (lane, state) walking its out-arcs, a CSR
// by source).  Each C entry point runs a window of W frames: the forward
// fills seq[1..W] from seq[0] (seq[i] = alpha before frame t0 + i), the
// backward walks the window's frames from the last, reading seq[i].
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kNeg = -1.0e30f;
constexpr int kThreads = 256;
constexpr int kPruneThreads = 1024;

__device__ __forceinline__ float emit(const float* ll, int pdf, float acwt) {
  return __fmul_rn(__ldg(ll + pdf), acwt);
}

__global__ void lane_relax_kernel(const float* __restrict__ alpha, const float* __restrict__ ll,
                                  long long lane_stride, const int* __restrict__ in_start,
                                  const int* __restrict__ in_src,
                                  const float* __restrict__ in_score,
                                  const int* __restrict__ in_pdf, float acwt, int s,
                                  float* __restrict__ out) {
  const int st = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = blockIdx.y;
  if (st >= s) return;
  const float* a = alpha + static_cast<size_t>(lane) * s;
  const float* l = ll + lane * lane_stride;
  float v = kNeg;
  const int end = in_start[st + 1];
  for (int j = in_start[st]; j < end; ++j) {
    const float sc = __fadd_rn(__fadd_rn(a[__ldg(in_src + j)], __ldg(in_score + j)),
                               emit(l, __ldg(in_pdf + j), acwt));
    v = fmaxf(v, sc);
  }
  out[static_cast<size_t>(lane) * s + st] = v;
}

// orderable key: a larger float has a larger key
__device__ __forceinline__ unsigned key_of(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float float_of(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__device__ float block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < static_cast<int>(blockDim.x >> 5) ? red[lane] : kNeg;
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  const float out = red[0];
  __syncthreads();
  return out;
}

__global__ void __launch_bounds__(kPruneThreads)
lane_prune_kernel(const float* __restrict__ relax, const float* __restrict__ alpha_cur,
                  float* __restrict__ alpha_next, float* __restrict__ at_end,
                  const int* __restrict__ nf, int t, float beam, int max_active, int s) {
  __shared__ float red[32];
  __shared__ unsigned hist[256];
  __shared__ unsigned sel[2];  // prefix, remaining rank
  const int lane = blockIdx.x;
  const size_t base = static_cast<size_t>(lane) * s;
  const float* r = relax + base;
  float m = kNeg;
  for (int i = threadIdx.x; i < s; i += blockDim.x) m = fmaxf(m, r[i]);
  const float best = block_max(m, red);
  const float thr = __fsub_rn(best, beam);
  float kth = -INFINITY;
  if (max_active > 0 && max_active < s) {
    // k-th largest of the beam-pruned scores, exactly: 4 passes of 8 bits
    unsigned prefix = 0, mask = 0;
    unsigned rank = static_cast<unsigned>(max_active);
    for (int shift = 24; shift >= 0; shift -= 8) {
      for (int i = threadIdx.x; i < 256; i += blockDim.x) hist[i] = 0;
      __syncthreads();
      for (int i = threadIdx.x; i < s; i += blockDim.x) {
        const float v = r[i];
        const unsigned k = key_of(v >= thr ? v : kNeg);
        if ((k & mask) == prefix) atomicAdd(&hist[(k >> shift) & 0xffu], 1u);
      }
      __syncthreads();
      if (threadIdx.x == 0) {
        unsigned cum = 0;
        int d = 255;
        for (; d > 0; --d) {
          if (cum + hist[d] >= rank) break;
          cum += hist[d];
        }
        sel[0] = prefix | (static_cast<unsigned>(d) << shift);
        sel[1] = rank - cum;
      }
      __syncthreads();
      prefix = sel[0];
      rank = sel[1];
      mask |= 0xffu << shift;
      __syncthreads();
    }
    kth = float_of(prefix);
  }
  const bool active = t < nf[lane];
  const bool end = t + 1 == nf[lane];
  for (int i = threadIdx.x; i < s; i += blockDim.x) {
    float o = r[i];
    o = o >= thr ? o : kNeg;
    o = o >= kth ? o : kNeg;
    const float na = active ? o : alpha_cur[base + i];
    alpha_next[base + i] = na;
    if (end) at_end[base + i] = na;
  }
}

__device__ __forceinline__ float beta_eff(const float* beta, const float* fin, bool at_last,
                                          int st) {
  return at_last ? fin[st] : beta[st];
}

__global__ void lane_bits_kernel(const float* __restrict__ alpha, const float* __restrict__ beta,
                                 const float* __restrict__ final_eff,
                                 const float* __restrict__ ll, long long lane_stride,
                                 const float* __restrict__ thresh,
                                 const int* __restrict__ arc_src, const int* __restrict__ arc_dst,
                                 const int* __restrict__ arc_pdf,
                                 const float* __restrict__ arc_score, const int* __restrict__ nf,
                                 int t, float acwt, int s, int a, int nbytes,
                                 uint8_t* __restrict__ bits) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = blockIdx.y;
  if (j >= nbytes) return;
  const size_t base = static_cast<size_t>(lane) * s;
  const bool active = t < nf[lane];
  const bool at_last = t + 1 == nf[lane];
  const float th = thresh[lane];
  const float* l = ll + lane * lane_stride;
  unsigned byte = 0;
  if (active) {
    const int lo = 8 * j;
    const int hi = min(lo + 8, a);
    for (int arc = lo; arc < hi; ++arc) {
      const float tail =
          __fadd_rn(__fadd_rn(emit(l, __ldg(arc_pdf + arc), acwt), __ldg(arc_score + arc)),
                    beta_eff(beta + base, final_eff + base, at_last, __ldg(arc_dst + arc)));
      const float gamma = __fadd_rn(alpha[base + __ldg(arc_src + arc)], tail);
      byte |= static_cast<unsigned>(gamma >= th) << (7 - (arc - lo));
    }
  }
  bits[static_cast<size_t>(lane) * nbytes + j] = static_cast<uint8_t>(byte);
}

__global__ void lane_beta_kernel(const float* __restrict__ beta, float* __restrict__ beta_out,
                                 const float* __restrict__ final_eff,
                                 const float* __restrict__ ll, long long lane_stride,
                                 const int* __restrict__ out_start,
                                 const int* __restrict__ out_dst,
                                 const float* __restrict__ out_score,
                                 const int* __restrict__ out_pdf, const int* __restrict__ nf,
                                 int t, float acwt, int s) {
  const int st = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = blockIdx.y;
  if (st >= s) return;
  const size_t base = static_cast<size_t>(lane) * s;
  if (t >= nf[lane]) {
    beta_out[base + st] = beta[base + st];
    return;
  }
  const bool at_last = t + 1 == nf[lane];
  const float* l = ll + lane * lane_stride;
  float v = kNeg;
  const int end = out_start[st + 1];
  for (int j = out_start[st]; j < end; ++j) {
    const float tail =
        __fadd_rn(__fadd_rn(emit(l, __ldg(out_pdf + j), acwt), __ldg(out_score + j)),
                  beta_eff(beta + base, final_eff + base, at_last, __ldg(out_dst + j)));
    v = fmaxf(v, tail);
  }
  beta_out[base + st] = v;
}

}  // namespace

// seq [W+1, B, S] f32: seq[0] holds alpha before frame t0, the launch fills
// seq[1..W]; at_end [B, S] updated in place; relax [B, S] scratch; ll [B, T, P].
extern "C" int vbt_lattice_lane_forward(float* seq, float* at_end, float* relax, const float* ll,
                                        int t_total, int p, const int* in_start,
                                        const int* in_src, const float* in_score,
                                        const int* in_pdf, const int* nf, int t0, int w,
                                        float acwt, float beam, int max_active, int b, int s,
                                        cudaStream_t stream) {
  if (b == 0 || s == 0 || w == 0) return 0;
  const size_t slab = static_cast<size_t>(b) * s;
  const long long lane_stride = static_cast<long long>(t_total) * p;
  const dim3 grid((s + kThreads - 1) / kThreads, b);
  for (int i = 0; i < w; ++i) {
    const int t = t0 + i;
    const float* ll_t = ll + static_cast<size_t>(t) * p;
    lane_relax_kernel<<<grid, kThreads, 0, stream>>>(seq + i * slab, ll_t, lane_stride, in_start,
                                                     in_src, in_score, in_pdf, acwt, s, relax);
    lane_prune_kernel<<<b, kPruneThreads, 0, stream>>>(relax, seq + i * slab,
                                                       seq + (i + 1) * slab, at_end, nf, t,
                                                       beam, max_active, s);
  }
  return cudaGetLastError();
}

// seq [W+1, B, S]: seq[i] alpha before frame t0 + i; beta [B, S] in/out (beta
// above the window in, beta at t0 out), beta_tmp [B, S] scratch; final_eff
// [B, S]; thresh [B]; bits [W, B, ceil(A/8)] the window's packed survivors.
extern "C" int vbt_lattice_lane_backward(const float* seq, float* beta, float* beta_tmp,
                                         const float* ll, int t_total, int p,
                                         const float* final_eff, const float* thresh,
                                         const int* arc_src, const int* arc_dst,
                                         const int* arc_pdf, const float* arc_score,
                                         const int* out_start, const int* out_dst,
                                         const float* out_score, const int* out_pdf,
                                         const int* nf, int t0, int w, float acwt, int b, int s,
                                         int a, uint8_t* bits, cudaStream_t stream) {
  if (b == 0 || s == 0 || w == 0) return 0;
  const size_t slab = static_cast<size_t>(b) * s;
  const int nbytes = (a + 7) / 8;
  const long long lane_stride = static_cast<long long>(t_total) * p;
  const dim3 grid_s((s + kThreads - 1) / kThreads, b);
  const dim3 grid_a((nbytes + kThreads - 1) / kThreads, b);
  float* cur = beta;
  float* nxt = beta_tmp;
  for (int i = w - 1; i >= 0; --i) {
    const int t = t0 + i;
    const float* ll_t = ll + static_cast<size_t>(t) * p;
    if (nbytes > 0)
      lane_bits_kernel<<<grid_a, kThreads, 0, stream>>>(
          seq + i * slab, cur, final_eff, ll_t, lane_stride, thresh, arc_src, arc_dst, arc_pdf,
          arc_score, nf, t, acwt, s, a, nbytes, bits + static_cast<size_t>(i) * b * nbytes);
    lane_beta_kernel<<<grid_s, kThreads, 0, stream>>>(cur, nxt, final_eff, ll_t, lane_stride,
                                                      out_start, out_dst, out_score, out_pdf,
                                                      nf, t, acwt, s);
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  if (cur != beta) {
    const cudaError_t err =
        cudaMemcpyAsync(beta, cur, slab * sizeof(float), cudaMemcpyDeviceToDevice, stream);
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}
