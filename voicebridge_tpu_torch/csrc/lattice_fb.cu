// K5: the lattice forward-backward's recompute-and-test step for Hopper
// (sm_90a), one frame or a window of frames per launch.
//
// Replaces the step ``fwd_frame`` of the XLA scan in
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
// final scores where the utterance ends at t + 1: the slab that K3's
// backward window stores) is in backward-plan space, and row_dst maps each
// forward row's destination there.  The recomputed alpha is the Viterbi
// forward of the same frame (K3's value), so a window replays its forward
// from the phase-1 snapshot while it tests every arc instance against the
// lattice beam.
//
// The work is K3's gathers (the alpha rows of every arc source, 246 MB of
// real arcs per frame at full width and B = 128, from an (S+1) x B table
// resident in the 50 MB L2), plus one beta read per unit and one survivor
// byte written per row and lane (R x B bytes per frame).
//
// Design (as K3, csrc/viterbi_step.cu): one warp per (state, 128 lanes),
// 4 lanes a thread as float4 gathers when B % 4 == 0 and the pointers are
// aligned; row indices loaded once per warp and passed by __shfl_sync, the
// next state's while this one is tested; D a template parameter (1..8: one
// byte holds a row's slots, bit k = slot k), the gathers of max(1, 8 / D)
// rows issued together; the pad slots of a row (trailing, source S, weight
// NEG_INF) share one value g_pad = alpha[S] + NEG_INF, computed once per
// frame, so their bits are one mask, set where g_pad + tail >= thresh; a
// window of frames is one cooperative launch with a grid sync between frames
// and alpha ping-ponging between two buffers.  As for K3, the bytes alone do
// not bound it at full width (PERF.md: half the lanes are not faster).  All
// rows of a state share its destination, so the beta gather is one read per
// unit.
// The arithmetic uses __fadd_rn/__fmul_rn in the JAX order,
// (alpha + w) + ((ll * acwt) + beta): the survivor bits equal the plain
// version's and the recomputed alpha equals the phase-1 snapshot bit for bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLanesPerWarp = 128;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNegInf = -1e30f;

struct K5Args {
  const float* alpha;       // [S+1, B] alpha at t0 (forward-plan space)
  float* buf0;              // [S+1, B] alpha after frames 0, 2, ... of the window
  float* buf1;              // [S+1, B] alpha after frames 1, 3, ... (W > 1)
  uint8_t* words;           // [W, R, B] survivor bytes
  const float* ll;          // [W, P, B]
  const float* beta;        // [W, S+1, B] beta above each frame (backward-plan space)
  const float* thresh;      // [B]
  const int* row_start;     // [S+2]
  const int* row_src;       // [R * D]
  const float* row_w;       // [R * D]
  const int* row_pdf;       // [R]
  const uint8_t* row_real;  // [R] real slots per row
  const int* row_dst;       // [R] destination in backward-plan space
  const int* num_frames;    // [B]
  int64_t frame_ll;         // P * B
  int64_t frame_words;      // R * B
  int t0, w, s1, b;
  float acwt;
};

template <bool VEC>
__device__ __forceinline__ void load_cg(const float* p, int nl, float (&x)[4]) {
  if (VEC) {
    if (nl > 0) {
      const float4 v = __ldcg(reinterpret_cast<const float4*>(p));
      x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) x[j] = j < nl ? __ldcg(p + j) : 0.f;
  }
}

template <bool VEC>
__device__ __forceinline__ void load_ro(const float* p, int nl, float (&x)[4]) {
  if (VEC) {
    if (nl > 0) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(p));
      x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) x[j] = j < nl ? __ldg(p + j) : 0.f;
  }
}

template <bool VEC>
__device__ __forceinline__ void store4(float* p, int nl, const float (&x)[4]) {
  if (VEC) {
    if (nl > 0) *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < nl) p[j] = x[j];
  }
}

template <bool VEC>
__device__ __forceinline__ void store_words(uint8_t* p, int nl, const unsigned (&c)[4]) {
  if (VEC) {
    if (nl > 0)
      *reinterpret_cast<uchar4*>(p) = make_uchar4(static_cast<uint8_t>(c[0]), static_cast<uint8_t>(c[1]),
                                                  static_cast<uint8_t>(c[2]), static_cast<uint8_t>(c[3]));
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < nl) p[j] = static_cast<uint8_t>(c[j]);
  }
}

// The lanes of one thread in one frame.
struct Lanes {
  int l0, nl;       // first lane, lanes held (0..4)
  bool act[4];      // t < nf
  float th[4];      // the lattice beam's threshold
  bool any_act, all_act;
};

template <bool VEC>
__device__ __forceinline__ Lanes lanes_of(const K5Args& a, int l0, int t) {
  Lanes ln;
  ln.l0 = l0;
  ln.nl = max(0, min(4, a.b - l0));
  ln.any_act = false;
  ln.all_act = true;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    ln.act[j] = j < ln.nl && t < __ldg(a.num_frames + l0 + j);
    ln.any_act |= ln.act[j];
    ln.all_act &= ln.act[j] || j >= ln.nl;
  }
  load_ro<VEC>(a.thresh + l0, ln.nl, ln.th);
  return ln;
}

// One warp-wide chunk of a state's rows: slot ``lane`` of the chunk's
// row_src/row_w, and row ``lane``'s pdf, real-slot count and destination.
struct Chunk {
  int src, pdf, real, dst;
  float w;
};

template <int D>
__device__ __forceinline__ Chunk load_chunk(const K5Args& a, int rb, int r1, int lane) {
  constexpr int kRows = 32 / D;
  const int nr = min(kRows, r1 - rb);
  Chunk c{0, 0, 0, 0, 0.f};
  if (lane < nr * D) {
    c.src = __ldg(a.row_src + static_cast<int64_t>(rb) * D + lane);
    c.w = __ldg(a.row_w + static_cast<int64_t>(rb) * D + lane);
  }
  if (lane < nr) {
    c.pdf = __ldg(a.row_pdf + rb + lane);
    c.real = __ldg(a.row_real + rb + lane);
    c.dst = __ldg(a.row_dst + rb + lane);
  }
  return c;
}

// One (state, 128-lane group) of one frame, rows [r0, r1), with the first
// chunk of its rows already loaded; called by all 32 threads of a warp (the
// row loops are warp-uniform).  The gathers of a group of max(1, 8 / D) rows
// (at most 4) are issued together; a row's acoustic score is gathered only
// when its pdf differs from the previous row's.
template <int D, bool VEC>
__device__ __forceinline__ void test_unit(const K5Args& a, const float* in, float* out,
                                          const float* ll_t, const float* beta_t,
                                          uint8_t* words_t, int s, const Lanes& ln,
                                          const float (&gp)[4], int r0, int r1, Chunk c) {
  constexpr int kRows = 32 / D;
  constexpr int kGroup = D >= 8 ? 1 : (8 / D > 4 ? 4 : 8 / D);
  constexpr unsigned kAll = (1u << D) - 1u;
  const int lane = threadIdx.x & 31;
  const int64_t b = a.b;
  float self[4] = {0.f, 0.f, 0.f, 0.f};
  if (!ln.all_act) load_cg<VEC>(in + s * b + ln.l0, ln.nl, self);
  if (!__any_sync(kFull, ln.any_act)) {  // no lane of the warp moves or keeps an arc
    const unsigned zero[4] = {0u, 0u, 0u, 0u};
    for (int r = r0; r < r1; ++r) store_words<VEC>(words_t + r * b + ln.l0, ln.nl, zero);
    store4<VEC>(out + s * b + ln.l0, ln.nl, self);
    return;
  }
  // all rows of a state share its destination: one beta gather
  float beta[4] = {0.f, 0.f, 0.f, 0.f};
  if (r1 > r0)
    load_ro<VEC>(beta_t + static_cast<int64_t>(__shfl_sync(kFull, c.dst, 0)) * b + ln.l0, ln.nl,
                 beta);
  float best[4] = {0.f, 0.f, 0.f, 0.f};
  int issue_pdf = -1;  // the pdf whose acoustic score was gathered last
  float cur_am[4];     // that score times acwt
  for (int rb = r0; rb < r1; rb += kRows) {
    if (rb != r0) c = load_chunk<D>(a, rb, r1, lane);
    const int nr = min(kRows, r1 - rb);
    for (int rr = 0; rr < nr; rr += kGroup) {
      int pdf[kGroup], nreal[kGroup], src[kGroup][D];
      float w[kGroup][D], am[kGroup][4], g[kGroup][D][4];
      bool need[kGroup];
#pragma unroll
      for (int q = 0; q < kGroup; ++q) {
        pdf[q] = __shfl_sync(kFull, c.pdf, rr + q);
        nreal[q] = rr + q < nr ? __shfl_sync(kFull, c.real, rr + q) : -1;
#pragma unroll
        for (int k = 0; k < D; ++k) {
          src[q][k] = __shfl_sync(kFull, c.src, (rr + q) * D + k);
          w[q][k] = __shfl_sync(kFull, c.w, (rr + q) * D + k);
        }
      }
#pragma unroll
      for (int q = 0; q < kGroup; ++q) {
        need[q] = nreal[q] >= 0 && pdf[q] != issue_pdf;
        if (need[q]) {
          load_ro<VEC>(ll_t + static_cast<int64_t>(pdf[q]) * b + ln.l0, ln.nl, am[q]);
          issue_pdf = pdf[q];
        }
#pragma unroll
        for (int k = 0; k < D; ++k)
          if (k < nreal[q]) load_cg<VEC>(in + static_cast<int64_t>(src[q][k]) * b + ln.l0, ln.nl,
                                         g[q][k]);
      }
#pragma unroll
      for (int q = 0; q < kGroup; ++q) {
        if (nreal[q] < 0) continue;
        if (need[q]) {
#pragma unroll
          for (int j = 0; j < 4; ++j) cur_am[j] = __fmul_rn(am[q][j], a.acwt);
        }
        unsigned word[4];
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float tail = __fadd_rn(cur_am[j], beta[j]);
          float mx = gp[j];  // a row that is all padding: every slot is g_pad
          unsigned bits = 0u;
#pragma unroll
          for (int k = 0; k < D; ++k) {
            if (k < nreal[q]) {
              const float x = __fadd_rn(g[q][k][j], w[q][k]);
              if (k == 0 || x > mx) mx = x;
              if (ln.act[j] && __fadd_rn(x, tail) >= ln.th[j]) bits |= 1u << k;
            }
          }
          if (nreal[q] < D) {  // the pad slots: one value, one mask
            if (nreal[q] > 0 && gp[j] > mx) mx = gp[j];
            if (ln.act[j] && __fadd_rn(gp[j], tail) >= ln.th[j])
              bits |= kAll & ~((1u << nreal[q]) - 1u);
          }
          word[j] = bits;
          v[j] = __fadd_rn(mx, cur_am[j]);
        }
        const int r = rb + rr + q;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (r == r0 || v[j] > best[j]) best[j] = v[j];
        store_words<VEC>(words_t + r * b + ln.l0, ln.nl, word);
      }
    }
  }
  float res[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) res[j] = ln.act[j] ? best[j] : self[j];
  store4<VEC>(out + s * b + ln.l0, ln.nl, res);
}

template <int D, bool VEC>
__global__ void __launch_bounds__(kThreads, 2) lattice_fb_kernel(const K5Args a) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int groups = (a.b + kLanesPerWarp - 1) / kLanesPerWarp;
  const int64_t units = static_cast<int64_t>(a.s1) * groups;
  const int64_t plane = static_cast<int64_t>(a.s1) * a.b;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int i = 0; i < a.w; ++i) {
    const float* in = i == 0 ? a.alpha : ((i & 1) ? a.buf0 : a.buf1);
    float* out = (i & 1) ? a.buf1 : a.buf0;
    const float* ll_t = a.ll + i * a.frame_ll;
    const float* beta_t = a.beta + i * plane;
    uint8_t* words_t = a.words + i * a.frame_words;
    // a thread's lanes and the pad value change only with the lane group;
    // the row bounds of the next two units and the first chunk of the next
    // one are in flight while a unit is tested
    int group = -1;
    Lanes ln;
    float gp[4];
    int rs0 = 0, rs1 = 0, rn0 = 0, rn1 = 0;
    if (first < units) {
      const int s = static_cast<int>(first / groups);
      rs0 = __ldg(a.row_start + s);
      rs1 = __ldg(a.row_start + s + 1);
    }
    if (first + stride < units) {
      const int s = static_cast<int>((first + stride) / groups);
      rn0 = __ldg(a.row_start + s);
      rn1 = __ldg(a.row_start + s + 1);
    }
    Chunk c = load_chunk<D>(a, rs0, rs1, lane);
    for (int64_t u = first; u < units; u += stride) {
      const Chunk cn = load_chunk<D>(a, rn0, rn1, lane);
      int rm0 = 0, rm1 = 0;
      if (u + 2 * stride < units) {
        const int s = static_cast<int>((u + 2 * stride) / groups);
        rm0 = __ldg(a.row_start + s);
        rm1 = __ldg(a.row_start + s + 1);
      }
      const int s = static_cast<int>(u / groups);
      const int g = static_cast<int>(u - static_cast<int64_t>(s) * groups);
      if (g != group) {
        group = g;
        ln = lanes_of<VEC>(a, g * kLanesPerWarp + lane * 4, a.t0 + i);
        load_cg<VEC>(in + static_cast<int64_t>(a.s1 - 1) * a.b + ln.l0, ln.nl, gp);
#pragma unroll
        for (int j = 0; j < 4; ++j) gp[j] = __fadd_rn(gp[j], kNegInf);
      }
      test_unit<D, VEC>(a, in, out, ll_t, beta_t, words_t, s, ln, gp, rs0, rs1, c);
      rs0 = rn0;
      rs1 = rn1;
      rn0 = rm0;
      rn1 = rm1;
      c = cn;
    }
    if (i + 1 < a.w) cg::this_grid().sync();
  }
}

// W == 1: an ordinary launch over all units (or max_blocks of them, striding).
// W > 1: a cooperative launch of the blocks that fit on the card at once.
template <int D, bool VEC>
cudaError_t launch(const K5Args& a, int max_blocks, cudaStream_t stream) {
  const int groups = (a.b + kLanesPerWarp - 1) / kLanesPerWarp;
  int64_t grid = (static_cast<int64_t>(a.s1) * groups + kWarps - 1) / kWarps;
  if (max_blocks > 0 && grid > max_blocks) grid = max_blocks;
  if (a.w == 1) {
    if (grid > 0x7fffffff) return cudaErrorInvalidValue;
    lattice_fb_kernel<D, VEC><<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(a);
    return cudaGetLastError();
  }
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lattice_fb_kernel<D, VEC>,
                                                        kThreads, 0);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  const int64_t resident = static_cast<int64_t>(per_sm) * sms;
  if (grid > resident) grid = resident;
  if (grid < 1) return cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {const_cast<K5Args*>(&a)};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(lattice_fb_kernel<D, VEC>),
                                     dim3(static_cast<unsigned>(grid)), dim3(kThreads), args, 0,
                                     stream);
}

template <bool VEC>
cudaError_t dispatch(const K5Args& a, int d, int max_blocks, cudaStream_t stream) {
  switch (d) {
    case 1: return launch<1, VEC>(a, max_blocks, stream);
    case 2: return launch<2, VEC>(a, max_blocks, stream);
    case 3: return launch<3, VEC>(a, max_blocks, stream);
    case 4: return launch<4, VEC>(a, max_blocks, stream);
    case 5: return launch<5, VEC>(a, max_blocks, stream);
    case 6: return launch<6, VEC>(a, max_blocks, stream);
    case 7: return launch<7, VEC>(a, max_blocks, stream);
    case 8: return launch<8, VEC>(a, max_blocks, stream);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned(const void* p, uintptr_t n) {
  return (reinterpret_cast<uintptr_t>(p) % n) == 0;
}

}  // namespace

// Runs frames t0 .. t0 + w - 1 from ``alpha``; alpha after the last frame is
// in buf0 when w is odd, else buf1.  max_blocks > 0 caps the grid.
extern "C" int vbt_lattice_fb(const float* alpha, float* buf0, float* buf1, uint8_t* words,
                              const float* ll, const float* beta, const float* thresh,
                              const int* row_start, const int* row_src, const float* row_w,
                              const int* row_pdf, const uint8_t* row_real, const int* row_dst,
                              const int* num_frames, int t0, int w, float acwt, int s1, int b,
                              int p, int r, int d, int max_blocks, void* stream) {
  if (d < 1 || d > 8 || w < 1 || (w > 1 && buf1 == nullptr)) return cudaErrorInvalidValue;
  if (static_cast<int64_t>(s1) * b == 0) return 0;
  const K5Args a{alpha, buf0, buf1, words, ll, beta, thresh, row_start, row_src, row_w, row_pdf,
                 row_real, row_dst, num_frames, static_cast<int64_t>(p) * b,
                 static_cast<int64_t>(r) * b, t0, w, s1, b, acwt};
  const bool vec = b % 4 == 0 && aligned(alpha, 16) && aligned(buf0, 16) && aligned(buf1, 16) &&
                   aligned(ll, 16) && aligned(beta, 16) && aligned(thresh, 16) &&
                   aligned(words, 4);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec ? dispatch<true>(a, d, max_blocks, s) : dispatch<false>(a, d, max_blocks, s);
}
