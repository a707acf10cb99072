// K1: fused MFCC / log-mel frame chain for Hopper (sm_90a), at every FFT
// size up to 4096 points.
//
// Replaces the Pallas TPU kernel voicebridge_tpu/ops/pallas_mfcc.py
// (_mfcc_kernel, launched by MfccPallas._run).  Per frame, in order: remove
// DC; raw log energy; preemphasis; window; real FFT; power spectrum; mel
// filterbank; log with floor; DCT; lifter.  Output row: the cepstra (or the
// log-mel bins in fbank mode, or the mel energies in mel_power mode: no log,
// no DCT, floored at mel_floor, which is -inf unless in HTK mode; PLP's front
// half), then the log energy.
//
// What bounds it on the H100: at 512 points a frame needs about 18k fp32
// operations (the FFT, the mel's nonzeros, the DCT) against 1.6 KB read, so
// the chain is bound by bytes (205 MB for 128k frames, 0.061 ms at
// 3.35 TB/s).  In practice each frame's chain of dependent stages runs
// through shared memory, so what limits it is shared-memory wavefronts per
// frame; the design keeps them few.
//
// Design.  Power-of-two sizes 64-4096 (mfcc_fft_kernel, N a template
// parameter): a group of T = max(32, N/16) threads per frame (one warp up to
// 512 points, 2-8 warps above), 256/T frames per block.  The window chain
// runs in registers (N/T samples per thread, group reductions by shuffles);
// the N real samples are stored as N/2 complex points and transformed by a
// Stockham radix-8 FFT (radix 2 or 4 last), one butterfly of up to 8 points
// per thread per pass in registers, one exchange through shared memory per
// pass (padded one float2 in 16: no bank conflicts in the scattered
// stores), then the real-input split step and the power spectrum.  Other
// sizes (400 points at 16 kHz without rounding to a power of two, 200, 551,
// 1103, 1200, ... up to 4096; mfcc_dft_kernel): the TPU kernel's own
// formulation, a product of a tile of F = 8 or 16 frames with the cos||sin
// table, register-blocked: one thread per frequency bin holds that bin for
// all F frames, the twiddles come from the host table every 16 samples and
// from at most four complex products of table values between; each block
// of 16 samples is summed apart, then added in.  Both end in the same tail: each mel
// bin sums only its own triangle ([mel_lo, mel_lo + mel_len) of the power
// spectrum, band-major weights: coalesced), in the dense loop's order with
// the same fmaf, so skipping exact zeros changes no bit; the DCT table is
// read from shared memory, staged once per block.  All arithmetic is IEEE
// fp32: no TF32, no tensor cores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxFft = 4096;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kFltEps = 1.1920928955078125e-07f;
constexpr float kSqrtHalf = 0.70710678118654752440f;

struct Chain {  // the window chain's options
  const float* window;
  int ws;
  int remove_dc;
  float preemph;
  int raw_energy;
};

enum Mode { kMfcc = 0, kFbank = 1, kMelPower = 2 };

struct Tail {  // mel, log, DCT, lifter and the output row
  const int* mel_lo;
  const int* mel_len;
  const float* mel_band;  // [max mel_len, num_bins]: weight i of bin b at i * num_bins + b
  int num_bins;
  const float* dct_t;  // [num_bins, num_ceps]
  const float* lifter;
  int num_ceps;
  float mel_floor;
  int mode;  // Mode
  float* out;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Barrier over one frame's group of T threads (named barrier 1 + group
// when several groups share a block).
template <int T>
__device__ __forceinline__ void group_sync(int group) {
  if constexpr (T == 32) {
    __syncwarp();
  } else if constexpr (T == kThreads) {
    __syncthreads();
  } else {
    asm volatile("bar.sync %0, %1;" ::"r"(group + 1), "n"(T) : "memory");
  }
}

template <int T>
__device__ __forceinline__ float group_sum(float v, float* red, int j, int group) {
  v = warp_sum(v);
  if constexpr (T == 32) {
    return v;
  } else {
    group_sync<T>(group);  // the previous sum's readers are done with red
    if ((j & 31) == 0) red[j >> 5] = v;
    group_sync<T>(group);
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < T / 32; ++w) s += red[w];
    return s;
  }
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 cadd(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float2 csub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }
__device__ __forceinline__ float2 mul_neg_i(float2 a) { return make_float2(a.y, -a.x); }

// In-register forward DFTs of 2, 4 and 8 points, natural order in and out.
template <int R>
__device__ __forceinline__ void dft(float2 (&v)[R]);

template <>
__device__ __forceinline__ void dft<2>(float2 (&v)[2]) {
  const float2 a = v[0], b = v[1];
  v[0] = cadd(a, b);
  v[1] = csub(a, b);
}

__device__ __forceinline__ void dft4(float2& v0, float2& v1, float2& v2, float2& v3) {
  const float2 t0 = cadd(v0, v2), t1 = csub(v0, v2);
  const float2 t2 = cadd(v1, v3), t3 = mul_neg_i(csub(v1, v3));
  v0 = cadd(t0, t2);
  v1 = cadd(t1, t3);
  v2 = csub(t0, t2);
  v3 = csub(t1, t3);
}

template <>
__device__ __forceinline__ void dft<4>(float2 (&v)[4]) {
  dft4(v[0], v[1], v[2], v[3]);
}

template <>
__device__ __forceinline__ void dft<8>(float2 (&v)[8]) {
  float2 e0 = v[0], e1 = v[2], e2 = v[4], e3 = v[6];
  float2 o0 = v[1], o1 = v[3], o2 = v[5], o3 = v[7];
  dft4(e0, e1, e2, e3);
  dft4(o0, o1, o2, o3);
  o1 = make_float2(kSqrtHalf * (o1.x + o1.y), kSqrtHalf * (o1.y - o1.x));    // * W8^1
  o2 = mul_neg_i(o2);                                                        // * W8^2
  o3 = make_float2(kSqrtHalf * (o3.y - o3.x), -kSqrtHalf * (o3.x + o3.y));   // * W8^3
  v[0] = cadd(e0, o0);
  v[4] = csub(e0, o0);
  v[1] = cadd(e1, o1);
  v[5] = csub(e1, o1);
  v[2] = cadd(e2, o2);
  v[6] = csub(e2, o2);
  v[3] = cadd(e3, o3);
  v[7] = csub(e3, o3);
}

// Complex point m of a frame's buffer: one float2 of padding in 16.
__device__ __forceinline__ int zphys(int m) { return m + (m >> 4); }
// Real sample i of the same buffer viewed as floats.
__device__ __forceinline__ int zfloat(int i) { return 2 * zphys(i >> 1) + (i & 1); }

// One Stockham pass of radix R over M complex points (NS: the size of the
// sub-transforms already done).  Twiddles W_M^e = W_N^(2e) from the N-entry
// table.
template <int M, int T, int R, int NS>
__device__ __forceinline__ void fft_pass(float2* z, const float2* tw, int j0, int group) {
  constexpr int B = M / R;
  constexpr int PER = (B + T - 1) / T;
  float2 v[PER][R];
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int j = j0 + q * T;
    if (B % T == 0 || j < B) {
      const int k = j % NS;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float2 a = z[zphys(j + r * B)];
        if (NS > 1 && r > 0) a = cmul(a, tw[2 * r * k * (M / (NS * R))]);
        v[q][r] = a;
      }
      dft<R>(v[q]);
    }
  }
  group_sync<T>(group);
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int j = j0 + q * T;
    if (B % T == 0 || j < B) {
      const int base = (j / NS) * NS * R + j % NS;
#pragma unroll
      for (int r = 0; r < R; ++r) z[zphys(base + r * NS)] = v[q][r];
    }
  }
  group_sync<T>(group);
}

template <int M, int T, int NS>
__device__ __forceinline__ void fft_passes(float2* z, const float2* tw, int j0, int group) {
  if constexpr (NS < M) {
    constexpr int R = M / NS >= 8 ? 8 : M / NS;
    fft_pass<M, T, R, NS>(z, tw, j0, group);
    fft_passes<M, T, NS * R>(z, tw, j0, group);
  }
}

// Mel (own triangle only), log with floor, DCT and lifter of one frame's
// power spectrum ``pw``, by its group of T threads; ``logmel`` is scratch
// of num_bins floats, ``dct`` the table in shared memory.
template <int T>
__device__ __forceinline__ void mel_dct_tail(const float* pw, float* logmel, const float* dct,
                                             const Tail& tl, int64_t f, float energy, int j,
                                             int group) {
  const int nb = tl.num_bins;
  for (int b = j; b < nb; b += T) {
    const int lo = tl.mel_lo[b], len = tl.mel_len[b];
    float acc = 0.f;
#pragma unroll 8
    for (int i = 0; i < len; ++i) acc = fmaf(pw[lo + i], tl.mel_band[i * nb + b], acc);
    const float v = fmaxf(acc, tl.mel_floor);
    const float lm = tl.mode == kMelPower ? v : logf(v);
    if (tl.mode != kMfcc) {
      tl.out[f * (nb + 1) + b] = lm;
    } else {
      logmel[b] = lm;
    }
  }
  if (tl.mode != kMfcc) {
    if (j == 0) tl.out[f * (nb + 1) + nb] = energy;
    return;
  }
  group_sync<T>(group);
  const int nc = tl.num_ceps;
  float* o = tl.out + f * (nc + 1);
  for (int c = j; c < nc; c += T) {
    float acc = 0.f;
    for (int b = 0; b < nb; ++b) acc = fmaf(logmel[b], dct[b * nc + c], acc);
    o[c] = acc * tl.lifter[c];
  }
  if (j == 0) o[nc] = energy;
}

__device__ __forceinline__ int dct_floats(const Tail& tl) {
  return tl.mode != kMfcc ? 0 : tl.num_bins * tl.num_ceps;
}

template <int N>
struct FftShape {
  static constexpr int M = N / 2;                      // complex points
  static constexpr int T = M / 8 > 32 ? M / 8 : 32;    // threads per frame
  static constexpr int FPB = kThreads / T;             // frames per block
  static constexpr int PER = N / T;                    // samples per thread
  static constexpr int ZLEN = M + M / 16;              // padded float2 per frame
};

template <int N>
__global__ void __launch_bounds__(kThreads)
mfcc_fft_kernel(const float* __restrict__ frames, int64_t num_frames, Chain ch,
                const float2* __restrict__ twiddle, Tail tl) {
  using S = FftShape<N>;
  constexpr int M = S::M, T = S::T, PER = S::PER;
  extern __shared__ __align__(16) float smem[];
  float2* tw = reinterpret_cast<float2*>(smem);                         // [N]
  float2* zall = tw + N;                                                // [FPB][ZLEN]
  float* dct = reinterpret_cast<float*>(zall + S::FPB * S::ZLEN);       // [bins * ceps]
  float* red = dct + dct_floats(tl);                                    // [FPB][T / 32]
  for (int i = threadIdx.x; i < N; i += kThreads) tw[i] = twiddle[i];
  for (int i = threadIdx.x; i < dct_floats(tl); i += kThreads) dct[i] = tl.dct_t[i];
  __syncthreads();

  const int group = threadIdx.x / T;
  const int j = threadIdx.x % T;
  const int64_t f = static_cast<int64_t>(blockIdx.x) * S::FPB + group;
  if (f >= num_frames) return;  // whole groups leave; only group barriers below
  float2* z = zall + group * S::ZLEN;
  float* zf = reinterpret_cast<float*>(z);
  float* gred = red + group * (T / 32);
  const float* x = frames + f * ch.ws;

  float v[PER];
  float s = 0.f;
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int i = j + T * q;
    v[q] = i < ch.ws ? x[i] : 0.f;
    s += v[q];
  }
  if (ch.remove_dc) {
    const float mean = group_sum<T>(s, gred, j, group) / static_cast<float>(ch.ws);
#pragma unroll
    for (int q = 0; q < PER; ++q)
      if (j + T * q < ch.ws) v[q] -= mean;
  }
  float e = 0.f;
#pragma unroll
  for (int q = 0; q < PER; ++q) e += v[q] * v[q];
  float energy = logf(fmaxf(group_sum<T>(e, gred, j, group), kFltEps));
  if (ch.preemph != 0.f) {
#pragma unroll
    for (int q = 0; q < PER; ++q) zf[zfloat(j + T * q)] = v[q];
    group_sync<T>(group);
    float prev[PER];
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int i = j + T * q;
      prev[q] = i > 0 ? zf[zfloat(i - 1)] : v[q];
    }
    group_sync<T>(group);  // every read done before the windowed stores
#pragma unroll
    for (int q = 0; q < PER; ++q)
      if (j + T * q < ch.ws) v[q] -= ch.preemph * prev[q];
  }
  float e2 = 0.f;
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int i = j + T * q;
    v[q] = i < ch.ws ? v[q] * __ldg(ch.window + i) : 0.f;
    e2 += v[q] * v[q];
    zf[zfloat(i)] = v[q];
  }
  if (!ch.raw_energy) energy = logf(fmaxf(group_sum<T>(e2, gred, j, group), kFltEps));
  group_sync<T>(group);

  // the N real samples as M complex points z[m] = x[2m] + i x[2m+1]
  fft_passes<M, T, 1>(z, tw, j, group);

  // X[k] = E[k] + W_N^k O[k], E = (Z[k] + conj Z[M-k]) / 2,
  // O = (Z[k] - conj Z[M-k]) / 2i; power of bins 0..M-1
  constexpr int KPER = M / T;
  float pw[KPER];
#pragma unroll
  for (int q = 0; q < KPER; ++q) {
    const int k = j + T * q;
    const float2 zk = z[zphys(k)];
    const float2 zm = z[zphys((M - k) & (M - 1))];
    const float er = 0.5f * (zk.x + zm.x), ei = 0.5f * (zk.y - zm.y);
    const float orr = 0.5f * (zk.y + zm.y), oi = -0.5f * (zk.x - zm.x);
    const float2 w = tw[k];
    const float xr = er + (w.x * orr - w.y * oi);
    const float xi = ei + (w.x * oi + w.y * orr);
    pw[q] = xr * xr + xi * xi;
  }
  group_sync<T>(group);
#pragma unroll
  for (int q = 0; q < KPER; ++q) zf[j + T * q] = pw[q];
  group_sync<T>(group);
  mel_dct_tail<T>(zf, zf + M, dct, tl, f, energy, j, group);
}

// Any size up to 4096 points: F frames a block, one warp's window chain per
// frame, then one thread per frequency bin over all F frames.
template <int F>
__global__ void __launch_bounds__(kThreads)
mfcc_dft_kernel(const float* __restrict__ frames, int64_t num_frames, Chain ch, int n_fft,
                const float2* __restrict__ twiddle, Tail tl) {
  extern __shared__ __align__(16) float smem[];
  const int ld = (ch.ws + 3) & ~3;  // row stride: float4-aligned
  const int nbf = n_fft / 2;        // frequency bins kept (0 .. N/2 - 1)
  float* xs = smem;                 // [F][ld] windowed frames, then log-mel scratch
  float* pws = xs + F * ld;         // [F][nbf] power spectra
  float* dct = pws + F * nbf;       // [bins * ceps]
  for (int i = threadIdx.x; i < dct_floats(tl); i += kThreads) dct[i] = tl.dct_t[i];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t f0 = static_cast<int64_t>(blockIdx.x) * F;
  constexpr int kWarps = kThreads / 32;
  float energies[F / kWarps];
#pragma unroll
  for (int slot = 0; slot < F / kWarps; ++slot) {
    const int ff = warp + kWarps * slot;
    float* row = xs + ff * ld;
    const int64_t f = f0 + ff;
    energies[slot] = 0.f;
    if (f >= num_frames) {
      for (int i = lane; i < ld; i += 32) row[i] = 0.f;
      continue;
    }
    const float* x = frames + f * ch.ws;
    float s = 0.f;
    for (int i = lane; i < ld; i += 32) {
      const float v = i < ch.ws ? x[i] : 0.f;
      row[i] = v;
      s += v;
    }
    __syncwarp();  // the preemphasis reads its neighbours' samples
    const float mean = ch.remove_dc ? warp_sum(s) / static_cast<float>(ch.ws) : 0.f;
    float e = 0.f;
    for (int i = lane; i < ch.ws; i += 32) {
      const float d = row[i] - mean;
      e += d * d;
    }
    float energy = logf(fmaxf(warp_sum(e), kFltEps));
    // preemphasis and window in place, 32 samples at a time from the end:
    // sample i - 1 of a chunk's first lane is still unchanged
    float e2 = 0.f;
    for (int base = ((ch.ws - 1) / 32) * 32; base >= 0; base -= 32) {
      const int i = base + lane;
      float cur = 0.f, prev = 0.f;
      if (i < ch.ws) {
        cur = row[i] - mean;
        prev = i > 0 ? row[i - 1] - mean : cur;
      }
      __syncwarp();
      if (i < ch.ws) {
        const float y = (ch.preemph != 0.f ? cur - ch.preemph * prev : cur) * __ldg(ch.window + i);
        row[i] = y;
        e2 += y * y;
      }
      __syncwarp();
    }
    if (!ch.raw_energy) energy = logf(fmaxf(warp_sum(e2), kFltEps));
    energies[slot] = energy;
  }
  __syncthreads();

  for (int k = threadIdx.x; k < nbf; k += kThreads) {
    float re[F], im[F];
#pragma unroll
    for (int ff = 0; ff < F; ++ff) re[ff] = im[ff] = 0.f;
    // W^(nk) for n = n0 + 4v + u: the table's value at n0 (every 16
    // samples), times W^(4k) v times (v < 4), times the table's W^(uk):
    // at most four roundings from exact values
    float2 sub[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) sub[u] = __ldg(twiddle + (u * k) % n_fft);
    const float2 step4 = __ldg(twiddle + (4 * k) % n_fft);
    for (int n0 = 0; n0 < ld; n0 += 16) {
      float2 w = __ldg(twiddle + (n0 * k) % n_fft);
      float br[F], bi[F];  // this block of 16 samples, summed apart: shorter chains of adds
#pragma unroll
      for (int ff = 0; ff < F; ++ff) br[ff] = bi[ff] = 0.f;
      const int n1 = min(n0 + 16, ld);
      for (int n = n0; n < n1; n += 4) {
        float4 xv[F];
#pragma unroll
        for (int ff = 0; ff < F; ++ff) xv[ff] = *reinterpret_cast<const float4*>(xs + ff * ld + n);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float2 wu = u == 0 ? w : cmul(w, sub[u]);
#pragma unroll
          for (int ff = 0; ff < F; ++ff) {
            const float x = u == 0 ? xv[ff].x : u == 1 ? xv[ff].y : u == 2 ? xv[ff].z : xv[ff].w;
            br[ff] = fmaf(x, wu.x, br[ff]);
            bi[ff] = fmaf(x, wu.y, bi[ff]);
          }
        }
        w = cmul(w, step4);
      }
#pragma unroll
      for (int ff = 0; ff < F; ++ff) {
        re[ff] += br[ff];
        im[ff] += bi[ff];
      }
    }
#pragma unroll
    for (int ff = 0; ff < F; ++ff) pws[ff * nbf + k] = re[ff] * re[ff] + im[ff] * im[ff];
  }
  __syncthreads();

#pragma unroll
  for (int slot = 0; slot < F / kWarps; ++slot) {
    const int ff = warp + kWarps * slot;
    const int64_t f = f0 + ff;
    if (f < num_frames)
      mel_dct_tail<32>(pws + ff * nbf, xs + ff * ld, dct, tl, f, energies[slot], lane, warp);
  }
}

template <int N>
cudaError_t launch_fft(const float* frames, int64_t num_frames, const Chain& ch,
                       const float* twiddle, const Tail& tl, cudaStream_t stream) {
  using S = FftShape<N>;
  const size_t smem = sizeof(float) * (2 * N + S::FPB * 2 * S::ZLEN +
                                       (tl.mode != kMfcc ? 0 : tl.num_bins * tl.num_ceps) +
                                       S::FPB * (S::T / 32));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mfcc_fft_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int64_t blocks = (num_frames + S::FPB - 1) / S::FPB;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  mfcc_fft_kernel<N><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      frames, num_frames, ch, reinterpret_cast<const float2*>(twiddle), tl);
  return cudaGetLastError();
}

template <int F>
cudaError_t launch_dft(const float* frames, int64_t num_frames, const Chain& ch, int n_fft,
                       const float* twiddle, const Tail& tl, cudaStream_t stream) {
  const int ld = (ch.ws + 3) & ~3;
  const size_t smem = sizeof(float) * (static_cast<size_t>(F) * (ld + n_fft / 2) +
                                       (tl.mode != kMfcc ? 0 : tl.num_bins * tl.num_ceps));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mfcc_dft_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int64_t blocks = (num_frames + F - 1) / F;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  mfcc_dft_kernel<F><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      frames, num_frames, ch, n_fft, reinterpret_cast<const float2*>(twiddle), tl);
  return cudaGetLastError();
}

}  // namespace

// twiddle: [n_fft] complex W_N^k = exp(-2 pi i k / N); mel_lo, mel_len,
// mel_band: each mel bin's triangle (see Tail).
extern "C" int vbt_mfcc_frames(const float* frames, int64_t num_frames, int ws, int n_fft,
                               const float* window, const float* twiddle, const int* mel_lo,
                               const int* mel_len, const float* mel_band, int num_bins,
                               const float* dct_t, const float* lifter, int num_ceps,
                               int remove_dc, float preemph, int raw_energy, float mel_floor,
                               int mode, float* out, void* stream) {
  if (num_frames == 0) return 0;
  if (ws < 1 || ws > n_fft || n_fft > kMaxFft || num_bins < 1 || num_bins > n_fft / 2 ||
      mode < kMfcc || mode > kMelPower ||
      (mode == kMfcc && (num_ceps < 1 || num_ceps > num_bins)))
    return cudaErrorInvalidValue;
  const Chain ch{window, ws, remove_dc, preemph, raw_energy};
  const Tail tl{mel_lo, mel_len, mel_band, num_bins, dct_t, lifter, num_ceps, mel_floor,
                mode, out};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_fft) {
    case 64: return launch_fft<64>(frames, num_frames, ch, twiddle, tl, s);
    case 128: return launch_fft<128>(frames, num_frames, ch, twiddle, tl, s);
    case 256: return launch_fft<256>(frames, num_frames, ch, twiddle, tl, s);
    case 512: return launch_fft<512>(frames, num_frames, ch, twiddle, tl, s);
    case 1024: return launch_fft<1024>(frames, num_frames, ch, twiddle, tl, s);
    case 2048: return launch_fft<2048>(frames, num_frames, ch, twiddle, tl, s);
    case 4096: return launch_fft<4096>(frames, num_frames, ch, twiddle, tl, s);
    default: break;
  }
  // 16 frames a block while they fit in 200 KB of shared memory, else 8
  const size_t per_frame = sizeof(float) * (((ws + 3) & ~3) + n_fft / 2);
  if (16 * per_frame <= 200 * 1024)
    return launch_dft<16>(frames, num_frames, ch, n_fft, twiddle, tl, s);
  return launch_dft<8>(frames, num_frames, ch, n_fft, twiddle, tl, s);
}

extern "C" const char* vbt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
