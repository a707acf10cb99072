// K6: aligned-GMM E-step statistics for Hopper (sm_90a).
//
// Replaces the XLA program voicebridge_tpu/ops/gmm_kernels.py
// (acc_gmm_stats_aligned_twofeats).  For every frame n of nonzero weight
// w_n, aligned to pdf p:
//
//   s_m   = gconst[p,m] + miv[p,m].x_post[n] - 0.5 iv[p,m].x_post[n]^2
//   g_m   = softmax_m(s) * w_n,           ll += logsumexp_m(s) * w_n
//   occ[p,m] += g_m,  mean[p,m,:] += g_m x_acc[n],  var[p,m,:] += g_m x_acc[n]^2
//
// What bounds it on the H100: very little work (2 M (2D) FLOPs per frame
// for the scores and as many for the sums; 80k frames x 5 x 78 is 60
// MFLOP), so launch latency and the gathers of frame rows.  The XLA program
// gathered every frame's [M, 2D] parameters into an [N, M, 2D] array and
// scattered with segment sums.  Here the caller sorts the frames by pdf and
// cuts each pdf's run into blocks (the work list is padded to a bound known
// on the host, so it is built without a synchronisation; padding blocks are
// empty), so one CTA serves one (pdf, frame block):
// it stages the pdf's [M, 2D+1] parameters in shared memory once, stages
// frames 32 at a time, and keeps the M (2D+1) sums of its block in shared
// memory as float64, each slot owned by one thread.  A second kernel sums
// each pdf's block partials in block order.  No float atomics: the result is
// the same in every run.  Splitting pdfs into blocks keeps a pdf that holds
// most frames (silence) from serialising on one SM.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;  // frames staged per step

__global__ void __launch_bounds__(kThreads)
gmm_stats_blocks(const float* __restrict__ x_post, const float* __restrict__ x_acc,
                 const float* __restrict__ weights, int d, const float* __restrict__ w,
                 int m, const int* __restrict__ order, const int* __restrict__ blk_pdf,
                 const int* __restrict__ blk_lo, const int* __restrict__ blk_hi,
                 double* __restrict__ partial) {
  extern __shared__ double dsm[];
  const int kdim = 2 * d + 1;
  const int slots = m * kdim;
  double* acc = dsm;                                     // [slots]
  double* ll_f = acc + slots;                            // [kTile]
  float* ws = reinterpret_cast<float*>(ll_f + kTile);    // [m][kdim]
  float* xp = ws + slots;                                // [kTile][d]
  float* xa = xp + kTile * d;                            // [kTile][d]
  float* sc = xa + kTile * d;                            // [kTile][m]
  float* wt = sc + kTile * m;                            // [kTile]
  const int blk = blockIdx.x;
  const int lo = blk_lo[blk];
  const int hi = blk_hi[blk];
  if (lo >= hi) return;  // past the real blocks: no pdf reads its partial
  const float* wp = w + static_cast<int64_t>(blk_pdf[blk]) * slots;
  for (int i = threadIdx.x; i < slots; i += kThreads) {
    ws[i] = wp[i];
    acc[i] = 0.0;
  }
  if (threadIdx.x < kTile) ll_f[threadIdx.x] = 0.0;

  for (int base = lo; base < hi; base += kTile) {
    const int nt = min(kTile, hi - base);
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < nt * d; i += kThreads) {
      const int f = i / d;
      const int64_t src = static_cast<int64_t>(order[base + f]) * d + (i - f * d);
      xp[i] = x_post[src];
      xa[i] = x_acc[src];
    }
    if (threadIdx.x < nt) wt[threadIdx.x] = weights[order[base + threadIdx.x]];
    __syncthreads();
    // component scores, one (frame, component) per thread
    for (int j = threadIdx.x; j < nt * m; j += kThreads) {
      const int f = j / m;
      const float* wc = ws + (j - f * m) * kdim;
      const float* x = xp + f * d;
      float s = wc[2 * d];
      for (int k = 0; k < d; ++k) {
        s = fmaf(wc[k], x[k], s);
        s = fmaf(wc[d + k], x[k] * x[k], s);
      }
      sc[j] = s;
    }
    __syncthreads();
    // posteriors times the frame weight, one frame per thread
    if (threadIdx.x < nt) {
      float* s = sc + threadIdx.x * m;
      float mx = s[0];
      for (int c = 1; c < m; ++c) mx = fmaxf(mx, s[c]);
      float sum = 0.f;
      for (int c = 0; c < m; ++c) sum += expf(s[c] - mx);
      const float wf = wt[threadIdx.x];
      for (int c = 0; c < m; ++c) s[c] = expf(s[c] - mx) / sum * wf;
      ll_f[threadIdx.x] += static_cast<double>((mx + logf(sum)) * wf);
    }
    __syncthreads();
    // block sums: slot (c, r) of [occ, mean[D], var[D]] owned by one thread
    for (int j = threadIdx.x; j < slots; j += kThreads) {
      const int c = j / kdim;
      const int r = j - c * kdim;
      double a = acc[j];
      if (r == 0) {
        for (int f = 0; f < nt; ++f) a += sc[f * m + c];
      } else if (r <= d) {
        for (int f = 0; f < nt; ++f) a += sc[f * m + c] * xa[f * d + r - 1];
      } else {
        for (int f = 0; f < nt; ++f) {
          const float x = xa[f * d + r - 1 - d];
          a += (sc[f * m + c] * x) * x;
        }
      }
      acc[j] = a;
    }
  }
  __syncthreads();
  double* out = partial + static_cast<int64_t>(blk) * (slots + 1);
  for (int i = threadIdx.x; i < slots; i += kThreads) out[i] = acc[i];
  if (threadIdx.x == 0) {
    double ll = 0.0;
    for (int f = 0; f < kTile; ++f) ll += ll_f[f];
    out[slots] = ll;
  }
}

// out[p, :] = sum of pdf p's block partials, in block order.
__global__ void __launch_bounds__(kThreads)
gmm_stats_reduce(const double* __restrict__ partial, int width,
                 const int* __restrict__ pdf_blk_lo, const int* __restrict__ pdf_blk_hi,
                 double* __restrict__ out) {
  const int p = blockIdx.x;
  const int lo = pdf_blk_lo[p];
  const int hi = pdf_blk_hi[p];
  for (int j = threadIdx.x; j < width; j += kThreads) {
    double s = 0.0;
    for (int blk = lo; blk < hi; ++blk) s += partial[static_cast<int64_t>(blk) * width + j];
    out[static_cast<int64_t>(p) * width + j] = s;
  }
}

}  // namespace

extern "C" int vbt_gmm_stats(const float* x_post, const float* x_acc, const float* weights,
                             int d, const float* w, int m, const int* order,
                             const int* blk_pdf, const int* blk_lo, const int* blk_hi,
                             int nblk, const int* pdf_blk_lo, const int* pdf_blk_hi,
                             int num_pdfs, double* partial, double* out, void* stream) {
  if (num_pdfs == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int slots = m * (2 * d + 1);
  if (nblk > 0) {
    const size_t smem = sizeof(double) * (slots + kTile) +
                        sizeof(float) * (slots + 2 * kTile * d + kTile * m + kTile);
    if (smem > 227 * 1024) return cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          gmm_stats_blocks, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return err;
    }
    gmm_stats_blocks<<<nblk, kThreads, smem, st>>>(x_post, x_acc, weights, d, w, m, order,
                                                   blk_pdf, blk_lo, blk_hi, partial);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  gmm_stats_reduce<<<num_pdfs, kThreads, 0, st>>>(partial, slots + 1, pdf_blk_lo, pdf_blk_hi,
                                                  out);
  return cudaGetLastError();
}
