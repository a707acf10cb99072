// K2 variant "dense": the kernel voicebridge_tpu_torch/csrc/gmm_loglik.cu
// was before it scored only live Gaussians.  Every pdf runs over the model's
// max_mix slots in a dense [M_pad, K_pad, P_pad] slab, dead slots (gconst
// -1e30) multiplied and masked like live ones.  Its C interface is the one
// it had then, (x, n, d, wt, p, m_pad, mc, out, stream); timed beside the
// shipped source by tools/time_frontend_kernels.py, which packs its slab.
//
// The note it carried follows.
//
// K2: fused diagonal-GMM log-likelihoods for Hopper (sm_90a), 3xTF32 on
// the tensor cores.
//
// Replaces the Pallas TPU kernel voicebridge_tpu/ops/pallas_gmm.py
// (_gmm_kernel, launched by _loglikes_padded).  Per (frame n, pdf p):
//
//   ll[n, p] = logsumexp_m(gconst[p,m] + miv[p,m].x[n] - 0.5 iv[p,m].x[n]^2)
//
// Components whose score is <= -5e29 (gconst = -1e30: inactive) are left out
// of the sum; a pdf with no active component gives -1e30.
//
// What bounds it on the H100: 2 (2D+1) operations per (frame, Gaussian):
// 2.0e11 for 128k frames x 10k Gaussians x 39 dims, 2.98 ms at the fp32
// peak (67 TFLOP/s).  Its output is 1.02 GB (0.31 ms at 3.35 TB/s); the
// component scores never leave registers (the plain version writes and
// re-reads 5 GB of them).
//
// Design: the product runs on the tensor cores as 3xTF32 (mma.sync
// m16n8k8): each fp32 operand a is split into a_hi = tf32(a) (rounded to
// nearest) and a_lo = tf32(a - a_hi), and a.b ~ a_hi.b_hi + a_hi.b_lo +
// a_lo.b_hi, which keeps the product within about 2^-21 of its fp32 value,
// where TF32 alone (2^-11) could not meet rtol 2e-5.  The tensor cores add
// into their accumulator without rounding to nearest, and the expanded form
// cancels large terms (|terms| up to 1e3 to 1e4 for a log-likelihood near
// -80 with the Yes-No model): so each k-step of 8 runs its three mma into a
// fresh accumulator, added to the running score with an fp32 FADD.  The
// bound is then 3 x 2 x N x (P M) x 80 operations at 495 TFLOP/s (1.24 ms
// at full width).  One 256-thread block per 128-frame x 64-pdf tile: the
// frame tile is staged once, read coalesced, as k-major columns [x, x^2, 1,
// 0...] (K padded to a multiple of 8); then for each of four 16-pdf
// sub-tiles and each chunk of MC components (all of them when M <= 5) the
// [K, 16] weight slabs are copied in with cp.async.  Each warp owns 32
// frames x 8 pdfs x MC components: per k-step it loads its A fragments (two
// m16 tiles) and one B fragment per component, splits them in registers
// with integer operations (no cvt), and issues three mma per (tile,
// component).  The n8 tiles of one warp are the MC components of the same 8
// pdfs, so every (frame, pdf) output's component scores sit in one thread:
// the logsumexp is a register epilogue (a max, one exp per component, one
// log per output) that folds each chunk into a running (max, sum).
// Shared-memory rows are padded to 136 and 24 floats: the fragment loads
// hit 32 distinct banks.  The wrapper packs the weights as [M_pad, K_pad,
// P_pad] (ops/gmm_kernel.py); ragged N and P are masked here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps: 4 along frames x 2 along pdfs
constexpr int kTileN = 128;    // frames per block
constexpr int kTileP = 64;     // pdfs per block, in sub-tiles of 16
constexpr int kSubP = 16;
constexpr int kLdX = kTileN + 8;
constexpr int kLdW = kSubP + 8;
constexpr int kMaxChunk = 5;
constexpr float kNeg = -1e30f;

// hi = v rounded to nearest TF32 (ties away from zero, as cvt.rna): add
// half of the 13 dropped bits' range to the magnitude and clear them; lo =
// the rest, rounded the same way
__device__ __forceinline__ uint32_t tf32_bits(uint32_t b) { return (b + 0x1000u) & 0xffffe000u; }

__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_bits(__float_as_uint(v));
  lo = tf32_bits(__float_as_uint(v - __uint_as_float(hi)));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int MC>
__global__ void __launch_bounds__(kThreads, 2)
gmm_loglik_kernel(const float* __restrict__ x, int64_t n, int d,
                  const float* __restrict__ wt, int p, int p_pad, int m_pad, int kp,
                  float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;               // [kp][kLdX]: x, x^2, 1, 0 per frame column
  float* ws = smem + kp * kLdX;   // [MC][kp][kLdW]: one chunk's weight slabs
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // fragment row group, thread in group
  const int wn = warp & 3;                // frames wn*32 .. +31
  const int wp = warp >> 2;               // pdfs wp*8 .. +7 of a sub-tile
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * kTileN;

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
  for (int idx = tid; idx < (kp - 2 * d) * kTileN; idx += kThreads) {
    const int r = idx / kTileN;
    xs[(2 * d + r) * kLdX + idx - r * kTileN] = r == 0 ? 1.f : 0.f;
  }

  for (int p0 = blockIdx.y * kTileP; p0 < (blockIdx.y + 1) * kTileP && p0 < p; p0 += kSubP) {
    // outputs of this thread: o = 4 i + r for m16 tile i and accumulator r
    // (rows g, g, g+8, g+8; columns 2t, 2t+1, 2t, 2t+1)
    float mx[8], sm[8];
#pragma unroll
    for (int o = 0; o < 8; ++o) {
      mx[o] = kNeg;
      sm[o] = 0.f;
    }
    for (int c0 = 0; c0 < m_pad; c0 += MC) {
      __syncthreads();  // the previous slabs are consumed (and xs is staged)
      for (int idx = tid; idx < MC * kp * (kSubP / 4); idx += kThreads) {
        const int q = idx & 3;
        const int row = idx >> 2;  // c * kp + k
        const int c = row / kp;
        const int k = row - c * kp;
        cp_async16(ws + row * kLdW + 4 * q,
                   wt + (static_cast<int64_t>(c0 + c) * kp + k) * p_pad + p0 + 4 * q);
      }
      asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
      __syncthreads();
      float acc[MC][2][4];
#pragma unroll
      for (int c = 0; c < MC; ++c)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[c][i][r] = 0.f;
      for (int k0 = 0; k0 < kp; k0 += 8) {
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float* a = xs + (k0 + t) * kLdX + wn * 32 + i * 16 + g;
          split(a[0], ah[i][0], al[i][0]);              // row g,   col t
          split(a[8], ah[i][1], al[i][1]);              // row g+8, col t
          split(a[4 * kLdX], ah[i][2], al[i][2]);       // row g,   col t+4
          split(a[4 * kLdX + 8], ah[i][3], al[i][3]);   // row g+8, col t+4
        }
#pragma unroll
        for (int c = 0; c < MC; ++c) {
          const float* b = ws + (c * kp + k0 + t) * kLdW + wp * 8 + g;
          uint32_t bh0, bl0, bh1, bl1;
          split(b[0], bh0, bl0);          // row k t,   col g
          split(b[4 * kLdW], bh1, bl1);   // row k t+4, col g
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            float s[4] = {0.f, 0.f, 0.f, 0.f};
            mma(s, al[i], bh0, bh1);
            mma(s, ah[i], bl0, bl1);
            mma(s, ah[i], bh0, bh1);
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[c][i][r] += s[r];
          }
        }
      }
      // fold the chunk into the running (max, sum): one exp per component
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int o = 4 * i + r;
          float cm = kNeg;
#pragma unroll
          for (int c = 0; c < MC; ++c) cm = fmaxf(cm, acc[c][i][r]);
          const float nm = fmaxf(mx[o], cm);
          float s = sm[o] * __expf(mx[o] - nm);
#pragma unroll
          for (int c = 0; c < MC; ++c) {
            const float v = acc[c][i][r];
            s += v > 0.5f * kNeg ? __expf(v - nm) : 0.f;
          }
          sm[o] = s;
          mx[o] = nm;
        }
    }

#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int o = 4 * i + r;
        const int64_t nn = n0 + wn * 32 + i * 16 + g + (r >= 2 ? 8 : 0);
        const int pp = p0 + wp * 8 + 2 * t + (r & 1);
        if (nn < n && pp < p)
          __stcs(out + nn * p + pp, mx[o] > 0.5f * kNeg ? mx[o] + logf(sm[o]) : kNeg);
      }
  }
}

template <int MC>
cudaError_t launch(const float* x, int64_t n, int d, const float* wt, int p, int m_pad,
                   float* out, cudaStream_t stream) {
  const int kp = (2 * d + 1 + 7) / 8 * 8;
  const int p_pad = (p + 63) / 64 * 64;
  const size_t smem = sizeof(float) * static_cast<size_t>(kp) * (kLdX + MC * kLdW);
  const int64_t nblocks = (n + kTileN - 1) / kTileN;
  const int pblocks = (p + kTileP - 1) / kTileP;  // p_pad covers them
  if (nblocks > 0x7fffffff || pblocks > 65535) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gmm_loglik_kernel<MC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(static_cast<unsigned>(nblocks), static_cast<unsigned>(pblocks));
  gmm_loglik_kernel<MC><<<grid, kThreads, smem, stream>>>(x, n, d, wt, p, p_pad, m_pad, kp,
                                                          out);
  return cudaGetLastError();
}

}  // namespace

// wt: [m_pad, K_pad, P_pad] float32, K_pad = 2d+1 rounded up to 8, P_pad =
// p rounded up to 64, rows [miv, -0.5 iv, gconst, 0...] of each component,
// padded components inactive; mc: components per chunk (1-5, divides m_pad).
extern "C" int vbt_gmm_loglikes(const float* x, int64_t n, int d, const float* wt, int p,
                                int m_pad, int mc, float* out, void* stream) {
  if (n == 0 || p == 0) return 0;
  if (d < 1 || mc < 1 || mc > kMaxChunk || m_pad % mc != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mc) {
    case 1: return launch<1>(x, n, d, wt, p, m_pad, out, s);
    case 2: return launch<2>(x, n, d, wt, p, m_pad, out, s);
    case 3: return launch<3>(x, n, d, wt, p, m_pad, out, s);
    case 4: return launch<4>(x, n, d, wt, p, m_pad, out, s);
    default: return launch<5>(x, n, d, wt, p, m_pad, out, s);
  }
}
