// K2 variant "fp32": the same function and dense C interface as
// tools/kernel_variants/k2_dense/gmm_loglik.cu, as a register-blocked fp32
// product on the CUDA cores (IEEE fp32 FMA, the arithmetic of the earlier
// fp32 kernel).  Timed beside the shipped source by
// tools/time_frontend_kernels.py.
//
// One 256-thread block per 128-frame x 64-pdf tile; each thread keeps an
// 8 x 4 register tile (frames ty*4 .. +3 and 64 + ty*4 .. +3, pdfs tx*4 ..
// +3) from float4 shared-memory loads: 32 FMA per 3 loads.  The frame tile
// [x, x^2, 1] is staged once, read coalesced; the components' [K, 64] weight slabs are
// double-buffered with cp.async, so component c+1 loads while c computes.
// The online logsumexp is branch-free: a select, one exp per component,
// one log per output.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileN = 128;
constexpr int kTileP = 64;
constexpr int kLdX = kTileN + 4;  // transposed staging stores: 4-way, not 32-way conflicts
constexpr float kNeg = -1e30f;

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void stage_slab(float* dst, const float* wt, int c, int kp, int p_pad,
                                           int p0, int tid) {
  for (int idx = tid; idx < kp * (kTileP / 4); idx += kThreads) {
    const int k = idx / (kTileP / 4);
    const int q = idx - k * (kTileP / 4);
    cp_async16(dst + k * kTileP + 4 * q,
               wt + (static_cast<int64_t>(c) * kp + k) * p_pad + p0 + 4 * q);
  }
  cp_commit();
}

__global__ void __launch_bounds__(kThreads, 2)
gmm_loglik_fp32_kernel(const float* __restrict__ x, int64_t n, int d,
                       const float* __restrict__ wt, int p, int p_pad, int m_pad, int kp,
                       float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                 // [kp][kLdX]
  float* ws = smem + kp * kLdX;     // [2][kp][kTileP]
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * kTileN;
  const int p0 = blockIdx.y * kTileP;
  const int kdim = 2 * d + 1;

  stage_slab(ws, wt, 0, kp, p_pad, p0, tid);
  // the tile's frames are kTileN * d contiguous floats: read them in order
  const int64_t left = n - n0;
  const int valid = static_cast<int>((left < kTileN ? left : kTileN) * d);
  for (int e = tid; e < kTileN * d; e += kThreads) {
    const int f = e / d;
    const int k = e - f * d;
    const float v = e < valid ? x[n0 * d + e] : 0.f;
    xs[k * kLdX + f] = v;
    xs[(d + k) * kLdX + f] = v * v;
  }
  for (int f = tid; f < kTileN; f += kThreads) xs[2 * d * kLdX + f] = 1.f;

  float mx[8][4], sm[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      mx[i][j] = kNeg;
      sm[i][j] = 0.f;
    }
  for (int c = 0; c < m_pad; ++c) {
    float* slab = ws + (c & 1) * kp * kTileP;
    if (c + 1 < m_pad) {
      stage_slab(ws + ((c + 1) & 1) * kp * kTileP, wt, c + 1, kp, p_pad, p0, tid);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int k = 0; k < kdim; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(xs + k * kLdX + ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(xs + k * kLdX + 64 + ty * 4);
      const float4 b = *reinterpret_cast<const float4*>(slab + k * kTileP + tx * 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bb[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float s = acc[i][j];
        const float dl = s - mx[i][j];
        const float e = __expf(-fabsf(dl));
        const float up = dl > 0.f ? fmaf(sm[i][j], e, 1.f) : sm[i][j] + e;
        const bool act = s > 0.5f * kNeg;
        sm[i][j] = act ? up : sm[i][j];
        mx[i][j] = act ? fmaxf(mx[i][j], s) : mx[i][j];
      }
    __syncthreads();  // this slab is consumed before it is staged again
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t nn = n0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (nn >= n) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int pp = p0 + tx * 4 + j;
      if (pp < p)
        __stcs(out + nn * p + pp, mx[i][j] > 0.5f * kNeg ? mx[i][j] + logf(sm[i][j]) : kNeg);
    }
  }
}

}  // namespace

extern "C" int vbt_gmm_loglikes(const float* x, int64_t n, int d, const float* wt, int p,
                                int m_pad, int mc, float* out, void* stream) {
  (void)mc;
  if (n == 0 || p == 0) return 0;
  const int kp = (2 * d + 1 + 7) / 8 * 8;
  const int p_pad = (p + 63) / 64 * 64;
  const size_t smem = sizeof(float) * static_cast<size_t>(kp) * (kLdX + 2 * kTileP);
  const int64_t nblocks = (n + kTileN - 1) / kTileN;
  const int pblocks = p_pad / kTileP;
  if (nblocks > 0x7fffffff || pblocks > 65535) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gmm_loglik_fp32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(static_cast<unsigned>(nblocks), static_cast<unsigned>(pblocks));
  gmm_loglik_fp32_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, n, d, wt, p, p_pad, m_pad, kp, out);
  return cudaGetLastError();
}
