// K2: fused diagonal-GMM log-likelihoods for Hopper (sm_90a), 3xTF32 on
// the tensor cores, over each pdf's live Gaussians only.
//
// Replaces the Pallas TPU kernel voicebridge_tpu/ops/pallas_gmm.py
// (_gmm_kernel, launched by _loglikes_padded).  Per (frame n, pdf p):
//
//   ll[n, p] = logsumexp_m(gconst[p,m] + miv[p,m].x[n] - 0.5 iv[p,m].x[n]^2)
//
// Components whose score is <= -5e29 (gconst = -1e30: inactive) are left out
// of the sum; a pdf with no active component gives -1e30.
//
// What bounds it on the H100: the live Gaussians, not the model's slots.
// 2 (2D+1) operations per (frame, live Gaussian): 2.0e11 for 128k frames x
// 10k Gaussians x 39 dims, 2.98 ms at the fp32 peak (67 TFLOP/s); as
// 3xTF32 over K padded to 8, 3 x 2 x N x live x K_pad operations at 495
// TFLOP/s (1.24 ms there).  Its output is 1.02 GB (0.31 ms at 3.35 TB/s);
// the component scores never leave registers (the plain version writes and
// re-reads 5 GB of them).  A model mixed up by occupancy has pdfs of 1 to
// max_mix Gaussians (LibriSpeech's tri2b: 3-15 in 16 slots, 6 on average),
// so a dense [max_mix, K, P] slab would score 2.7 slots a live Gaussian.
//
// Layout (ops/gmm_kernel.py, built on the host from which components are
// live): each pdf's live components first; within each 64-pdf tile the
// pdfs ordered by their count, most first, so the 16 pdfs of a sub-tile,
// and the 8 of a warp's n8 group, have near-equal counts; sub-tile s owns
// tiles[s].y slabs of [K_pad, 16] floats from slab tiles[s].x on (its
// largest count; a slot past a pdf's own count is a dead slot), and
// order[16 s + j] is the model pdf of its column j (-1: none).  The block
// still writes only its own tile's 64 columns, within a 256-byte span of
// each output row.  A dense model (every count equal) gets one count a
// tile, the model order and the dense work.
//
// Design: the product runs on the tensor cores as 3xTF32 (mma.sync
// m16n8k8): each fp32 operand a is split into a_hi = tf32(a) (rounded to
// nearest) and a_lo = tf32(a - a_hi), and a.b ~ a_hi.b_hi + a_hi.b_lo +
// a_lo.b_hi, which keeps the product within about 2^-21 of its fp32 value,
// where TF32 alone (2^-11) could not meet rtol 2e-5.  The tensor cores add
// into their accumulator without rounding to nearest, and the expanded form
// cancels large terms (|terms| up to 1e3 to 1e4 for a log-likelihood near
// -80 with the Yes-No model): so each k-step of 8 runs its three mma into a
// fresh accumulator, added to the running score with an fp32 FADD.  One
// 256-thread block per 128-frame x 64-pdf tile: the frame tile is staged
// once, read coalesced, as k-major columns [x, x^2, 1, 0...] (K padded to a
// multiple of 8); then for each of its four 16-pdf sub-tiles the sub-tile's
// slabs run in chunks of at most 5, as few chunks as will do and equal in
// size but the last, which takes the remainder (a count of 6 is two chunks
// of 3, 11 is 4, 4, 3); each chunk's slabs are contiguous and copied in with
// cp.async, and the chunk's size picks a code path compiled for it.  Each
// warp owns 32 frames x 8 pdfs x the chunk's components: per k-step it
// loads its A fragments (two m16 tiles) and one B fragment per component,
// splits them in registers with integer operations (no cvt), and issues
// three mma per (tile, component).  The n8 tiles of one warp are the
// components of the same 8 pdfs, so every (frame, pdf) output's component
// scores sit in one thread: the logsumexp is a register epilogue (a max,
// one exp per component, one log per output) that folds each chunk into a
// running (max, sum).  Shared-memory rows are padded to 136 and 24 floats:
// the fragment loads hit 32 distinct banks.  Ragged N is masked here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps: 4 along frames x 2 along pdfs
constexpr int kTileN = 128;    // frames per block
constexpr int kSubP = 16;      // pdfs per sub-tile
constexpr int kSubTiles = 4;   // sub-tiles per block: 64 pdfs
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

// One chunk of MC staged slabs: the warp's 32 frames x 8 pdfs x MC
// components, folded into the running (max, sum) of its outputs o = 4 i + r
// (m16 tile i, accumulator r: rows g, g, g+8, g+8; columns 2t, 2t+1, 2t,
// 2t+1)
template <int MC>
__device__ __forceinline__ void score_chunk(const float* xs, const float* ws, int kp, int wn,
                                            int wp, int g, int t, float (&mx)[8],
                                            float (&sm)[8]) {
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

__global__ void __launch_bounds__(kThreads, 2)
gmm_loglik_kernel(const float* __restrict__ x, int64_t n, int d,
                  const float* __restrict__ wt, const int2* __restrict__ tiles,
                  const int* __restrict__ order, int subtiles, int p, int kp,
                  float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;               // [kp][kLdX]: x, x^2, 1, 0 per frame column
  float* ws = smem + kp * kLdX;   // [kMaxChunk][kp][kLdW]: one chunk's weight slabs
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

  const int s_end = min(subtiles, static_cast<int>(blockIdx.y + 1) * kSubTiles);
  for (int s = blockIdx.y * kSubTiles; s < s_end; ++s) {
    const int2 tile = tiles[s];  // (first slab, slabs)
    float mx[8], sm[8];
#pragma unroll
    for (int o = 0; o < 8; ++o) {
      mx[o] = kNeg;
      sm[o] = 0.f;
    }
    const int passes = (tile.y + kMaxChunk - 1) / kMaxChunk;
    const int step = passes > 0 ? (tile.y + passes - 1) / passes : 1;
    for (int c0 = 0; c0 < tile.y; c0 += step) {
      const int mc = min(step, tile.y - c0);
      __syncthreads();  // the previous slabs are consumed (and xs is staged)
      const float* src = wt + static_cast<int64_t>(tile.x + c0) * kp * kSubP;
      for (int idx = tid; idx < mc * kp * (kSubP / 4); idx += kThreads) {
        const int q = idx & 3;
        const int row = idx >> 2;  // c * kp + k
        cp_async16(ws + row * kLdW + 4 * q, src + row * kSubP + 4 * q);
      }
      asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
      __syncthreads();
      switch (mc) {
        case 1: score_chunk<1>(xs, ws, kp, wn, wp, g, t, mx, sm); break;
        case 2: score_chunk<2>(xs, ws, kp, wn, wp, g, t, mx, sm); break;
        case 3: score_chunk<3>(xs, ws, kp, wn, wp, g, t, mx, sm); break;
        case 4: score_chunk<4>(xs, ws, kp, wn, wp, g, t, mx, sm); break;
        default: score_chunk<5>(xs, ws, kp, wn, wp, g, t, mx, sm); break;
      }
    }

    const int col = s * kSubP + wp * 8 + 2 * t;
    const int pdf[2] = {order[col], order[col + 1]};
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int o = 4 * i + r;
        const int64_t nn = n0 + wn * 32 + i * 16 + g + (r >= 2 ? 8 : 0);
        const int pp = pdf[r & 1];
        if (nn < n && pp >= 0)
          __stcs(out + nn * p + pp, mx[o] > 0.5f * kNeg ? mx[o] + logf(sm[o]) : kNeg);
      }
  }
}

}  // namespace

// wt: [R, K_pad, 16] float32 slabs, K_pad = 2d+1 rounded up to 8, rows
// [miv, -0.5 iv, gconst, 0...] of one component of each of a sub-tile's 16
// pdfs (dead slots: zeros and gconst -1e30); tiles: [ceil(p/16)] int2 (first
// slab, slabs) of each 16-pdf sub-tile; order: [16 ceil(p/16)] int32, the
// model pdf of each packed column or -1.
extern "C" int vbt_gmm_loglikes(const float* x, int64_t n, int d, const float* wt,
                                const int* tiles, const int* order, int p, float* out,
                                void* stream) {
  if (n == 0 || p == 0) return 0;
  if (d < 1) return cudaErrorInvalidValue;
  const int kp = (2 * d + 1 + 7) / 8 * 8;
  const int subtiles = (p + kSubP - 1) / kSubP;
  const size_t smem = sizeof(float) * static_cast<size_t>(kp) * (kLdX + kMaxChunk * kLdW);
  const int64_t nblocks = (n + kTileN - 1) / kTileN;
  const int pblocks = (subtiles + kSubTiles - 1) / kSubTiles;
  if (nblocks > 0x7fffffff || pblocks > 65535) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gmm_loglik_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(static_cast<unsigned>(nblocks), static_cast<unsigned>(pblocks));
  gmm_loglik_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, n, d, wt, reinterpret_cast<const int2*>(tiles), order, subtiles, p, kp, out);
  return cudaGetLastError();
}
