// K7: the exact N-best Viterbi relaxation for Hopper (sm_90a), a window of
// frames per cooperative launch.
//
// Replaces the XLA scan of voicebridge_tpu/ops/viterbi.py
// (viterbi_nbest_forward -> one_step and _nbest_reduce).  Every state of a
// shared graph carries its K best partial-path scores, best first.  For
// utterance lane b and state s, over the arcs j entering s (grouped by
// destination, ascending arc id) and the source's slots q:
//
//   cand(j, q)    = alpha[src[j], b, q] + (score[j] + fl(ll_t[pdf[j], b] * acwt))
//   top K of cand -> alpha'[s, b, :], bp_arc[s, b, :] = arc id, bp_slot = q
//   best[b]       = max over states of alpha'[s, b, 0]
//   alpha'[s,b,k] = NEG_INF where alpha'[s, b, k] < best[b] - beam
//
// Ties: the JAX package takes top_k at every level of a reduction tree over
// the destination-sorted arcs, which orders equal values by (position in
// that arc list, source slot).  Here a thread meets the candidates in just
// that order and inserts with a strict >, so an earlier candidate stays
// ahead of a later equal one.  A slot that holds NEG_INF (no candidate, or
// pruned by the beam) carries arc -1 and slot 0.  Frames at or past an
// utterance's length keep the old alpha and write arc -1; alpha_end takes
// the (pruned) alpha of the utterance's last frame.  The adds and the
// multiply are __fadd_rn / __fmul_rn in the JAX order, so equal inputs give
// bit-equal scores and equal provenance as the plain version.
//
// What bounds it on the H100: not bytes.  A window reads and writes the
// [S, B, K] scores once and each frame writes 5 bytes of backpointers per
// (state, lane, slot): 38.7 MB a frame over 1000 frames at 32 lanes x 4
// slots on the 60k-state / 480k-arc graph, 0.0116 ms at 3.35 TB/s.  Its
// gathers (every source's K-list for every arc and lane, 246 MB a frame)
// come from the 50 MB L2, which holds the ping-pong score buffers.  The same
// bytes take longer when more candidates enter the lists, so the per-arc
// work (prune on read, merge) holds it; more gathers in flight per warp did
// not help.
//
// Design:
// * Lane-minor layout [S, B, K]: a warp takes one state and 32 lanes, a
//   thread one lane, so the warp reads a source's lists for its 32 lanes as
//   32 x K x 4 contiguous bytes (float4 loads when K is 4, 8 or 16), the
//   acoustic scores as one 128-byte row of ll [P, B], and writes its output
//   lists and backpointers contiguously.  The state's CSR row is read once
//   per warp, 32 arcs at a time, one arc a thread, and passed on by
//   __shfl_sync; the next arc's lists are loaded before the current ones are
//   inserted (K <= 8).  A batch of fewer than 32 lanes leaves lanes idle.
// * The list lives in registers (KM = 1, 2, 4, 8 or 16 slots; the first K
//   are written), with the arc id and the slot packed in one int (arc << 4
//   | slot: arc ids below 2^27).  Source lists are sorted, so a source is
//   skipped when its best candidate does not enter; else its candidates are
//   merged in by a bitonic network, branch-free across the warp's lanes,
//   ordered by score and then (arc, slot), the order the candidates are met
//   in, which keeps the ties of the insertion that defines the result.
// * One cooperative launch runs W frames, sized to the blocks that fit on
//   the card at once; blocks stride over (lane group, 8 states) units in the
//   same order every frame, so a thread meets the same (state, lane) each
//   frame.  Frame i writes its raw top-K scores into one of two ping-pong
//   buffers and folds each block's lane maxima into best[i % 3] with one
//   integer atomic max per lane and block.  One grid sync a frame: the beam
//   is applied on read, by frame i + 1, which keeps a source's score only if
//   it reaches best[i % 3] - beam; the thread that owns (s, b) reads its own
//   raw list of frame i, marks the pruned slots' backpointers arc -1 / slot 0,
//   and captures alpha_end or copies the list forward where the lane ends.
//   best needs three buffers: frame i folds into one, reads the one before,
//   and block 0 resets the one after.  After the last frame a final phase
//   prunes its lists in place.  Gathers of the ping-pong buffers go through
//   L2 (__ldcg), since other blocks wrote them in this launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr float kNeg = -1.0e30f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNone = -16;  // packed provenance: arc -1, slot 0

struct K7Args {
  const float* alpha;  // [S, B, K] input of the first frame
  float* buf0;         // [S, B, K] output of frames 0, 2, 4, ... of the launch
  float* buf1;         // [S, B, K] output of frames 1, 3, ... (W > 1)
  float* alpha_end;    // [S, B, K] updated in place
  int* bp_arc;         // [W, S, B, K]
  int8_t* bp_slot;     // [W, S, B, K]
  float* best;         // [3, B] lane maxima of frames i % 3 (kNeg on entry)
  const float* ll;     // [W, P, B]
  const int* in_start;  // [S+1]
  const int* src;       // [A] by destination
  const int* pdf;
  const float* score;
  const int* arc;       // original arc id
  const int* num_frames;  // [B]
  int64_t frame_ll;   // P * B
  int64_t frame_tab;  // S * B * K
  int t0, w, b, s, k;
  float acwt, beam;
};

// max for floats that may be negative, through the integer atomics
__device__ __forceinline__ void atomic_max_float(float* addr, float v) {
  if (v >= 0.f)
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  else
    atomicMin(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
}

// A lane's K-list at p (k slots; KM - k trailing slots read as kNeg).
template <int KM, bool VEC>
__device__ __forceinline__ void load_list(const float* p, int k, float (&x)[KM]) {
  if constexpr (VEC) {
#pragma unroll
    for (int i = 0; i < KM / 4; ++i) {
      const float4 v = __ldcg(reinterpret_cast<const float4*>(p) + i);
      x[4 * i] = v.x;
      x[4 * i + 1] = v.y;
      x[4 * i + 2] = v.z;
      x[4 * i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < KM; ++q) x[q] = q < k ? __ldcg(p + q) : kNeg;
  }
}

template <int KM, bool VEC>
__device__ __forceinline__ void store_list(float* p, int k, const float (&x)[KM]) {
  if constexpr (VEC) {
#pragma unroll
    for (int i = 0; i < KM / 4; ++i)
      reinterpret_cast<float4*>(p)[i] =
          make_float4(x[4 * i], x[4 * i + 1], x[4 * i + 2], x[4 * i + 3]);
  } else {
#pragma unroll
    for (int q = 0; q < KM; ++q)
      if (q < k) p[q] = x[q];
  }
}

// Backpointers of a list: arc = prov >> 4, slot = prov & 15.
template <int KM, bool VEC>
__device__ __forceinline__ void store_prov(int* pa, int8_t* ps, int k, const int (&prov)[KM]) {
  if constexpr (VEC) {
#pragma unroll
    for (int i = 0; i < KM / 4; ++i) {
      reinterpret_cast<int4*>(pa)[i] = make_int4(prov[4 * i] >> 4, prov[4 * i + 1] >> 4,
                                                 prov[4 * i + 2] >> 4, prov[4 * i + 3] >> 4);
      uint32_t slots = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) slots |= static_cast<uint32_t>(prov[4 * i + j] & 15) << (8 * j);
      reinterpret_cast<uint32_t*>(ps)[i] = slots;
    }
  } else {
#pragma unroll
    for (int q = 0; q < KM; ++q)
      if (q < k) {
        pa[q] = prov[q] >> 4;
        ps[q] = static_cast<int8_t>(prov[q] & 15);
      }
  }
}

// The block's lane maxima of one lane group into best (one atomic per lane).
__device__ __forceinline__ void flush_best(float (&red)[kWarps][32], float m, float* best, int g,
                                           int b) {
  red[threadIdx.x >> 5][threadIdx.x & 31] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    float x = red[0][threadIdx.x];
#pragma unroll
    for (int i = 1; i < kWarps; ++i) x = fmaxf(x, red[i][threadIdx.x]);
    const int l = g * 32 + threadIdx.x;
    if (l < b && x > kNeg) atomic_max_float(best + l, x);
  }
  __syncthreads();
}

// One source's candidates into the thread's top-K list (v, prov): its
// sorted slots x, pruned first against thr when ``prune``, plus the arc's
// weight (arc score wj, acoustic score llv); aj is the arc id.
template <int KM>
__device__ __forceinline__ void consider(float (&x)[KM], float llv, float wj, int aj, float acwt,
                                         int k, bool prune, float thr, float (&v)[KM],
                                         int (&prov)[KM]) {
  if (prune) {
#pragma unroll
    for (int q = 0; q < KM; ++q) x[q] = x[q] >= thr ? x[q] : kNeg;
  }
  if (!(x[0] > kNeg)) return;  // the source holds no hypothesis
  const float w = __fadd_rn(wj, __fmul_rn(llv, acwt));
  if (!(__fadd_rn(x[0], w) > v[KM - 1])) return;  // nor will its later slots
  // merge the source's sorted candidates into the sorted list: keep the
  // better of v[i] and c[KM-1-i] (a bitonic sequence holding the top KM of
  // both), then sort it; better = larger score, then smaller (arc, slot),
  // which is the order the candidates are met in
  float c[KM];
  int cp[KM];
#pragma unroll
  for (int q = 0; q < KM; ++q) {
    const bool live = q < k && x[q] > kNeg;
    c[q] = live ? __fadd_rn(x[q], w) : kNeg;
    cp[q] = live ? ((aj << 4) | q) : kNone;
  }
#pragma unroll
  for (int i = 0; i < KM; ++i) {
    const int j = KM - 1 - i;
    if (c[j] > v[i] || (c[j] == v[i] && cp[j] < prov[i])) {
      v[i] = c[j];
      prov[i] = cp[j];
    }
  }
#pragma unroll
  for (int st = KM / 2; st > 0; st >>= 1) {
#pragma unroll
    for (int i = 0; i < KM; ++i) {
      if (i & st) continue;
      if (v[i + st] > v[i] || (v[i + st] == v[i] && prov[i + st] < prov[i])) {
        const float tv = v[i];
        v[i] = v[i + st];
        v[i + st] = tv;
        const int tp = prov[i];
        prov[i] = prov[i + st];
        prov[i + st] = tp;
      }
    }
  }
}

// One state's top-K for the thread's lane at frame i, from the lists in
// ``in`` (pruned on read against thr when ``prune``).  Called by all 32
// threads of a warp: the arc loops are warp-uniform, ``act`` is not.
template <int KM, bool VEC>
__device__ __forceinline__ void relax(const K7Args& a, const float* in, int i, int st, int l,
                                      bool act, bool prune, float thr, float (&v)[KM],
                                      int (&prov)[KM]) {
  constexpr bool kPrefetch = KM <= 8;
  const int lane = threadIdx.x & 31;
  const int64_t b = a.b;
  const int k = a.k;
#pragma unroll
  for (int q = 0; q < KM; ++q) {
    v[q] = kNeg;
    prov[q] = kNone;
  }
  const int j0 = __ldg(a.in_start + st);
  const int j1 = __ldg(a.in_start + st + 1);
  const float* ll_b = a.ll + i * a.frame_ll + l;
  for (int jb = j0; jb < j1; jb += 32) {
    const int n = min(32, j1 - jb);
    int c_src = 0, c_pdf = 0, c_arc = -1;
    float c_w = 0.f;
    if (lane < n) {
      c_src = __ldg(a.src + jb + lane);
      c_pdf = __ldg(a.pdf + jb + lane);
      c_w = __ldg(a.score + jb + lane);
      c_arc = __ldg(a.arc + jb + lane);
    }
    float xn[KM];
    float lln = 0.f;
    if constexpr (kPrefetch) {
      const int s0 = __shfl_sync(kFull, c_src, 0);
      const int p0 = __shfl_sync(kFull, c_pdf, 0);
      if (act) {
        load_list<KM, VEC>(in + (s0 * b + l) * k, k, xn);
        lln = __ldg(ll_b + p0 * b);
      }
    }
    for (int jj = 0; jj < n; ++jj) {
      const float wj = __shfl_sync(kFull, c_w, jj);
      const int aj = __shfl_sync(kFull, c_arc, jj);
      float x[KM];
      float llv = 0.f;
      if constexpr (kPrefetch) {
#pragma unroll
        for (int q = 0; q < KM; ++q) x[q] = xn[q];
        llv = lln;
        if (jj + 1 < n) {
          const int s2 = __shfl_sync(kFull, c_src, jj + 1);
          const int p2 = __shfl_sync(kFull, c_pdf, jj + 1);
          if (act) {
            load_list<KM, VEC>(in + (s2 * b + l) * k, k, xn);
            lln = __ldg(ll_b + p2 * b);
          }
        }
      } else {
        const int sj = __shfl_sync(kFull, c_src, jj);
        const int pj = __shfl_sync(kFull, c_pdf, jj);
        if (act) {
          load_list<KM, VEC>(in + (sj * b + l) * k, k, x);
          llv = __ldg(ll_b + pj * b);
        }
      }
      if (act) consider<KM>(x, llv, wj, aj, a.acwt, k, prune, thr, v, prov);
    }
  }
}

// Phase i < W relaxes frame t0 + i (and finishes frame i - 1's lists);
// phase W finishes the last frame's lists.  Grid syncs between phases.
template <int KM, bool VEC>
__global__ void __launch_bounds__(kThreads, 2) nbest_window_kernel(const K7Args a) {
  __shared__ float red[kWarps][32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t b = a.b;
  const int k = a.k;
  const int groups = (a.b + 31) / 32;
  const int per_group = (a.s + kWarps - 1) / kWarps;
  const int64_t units = static_cast<int64_t>(groups) * per_group;
  for (int i = 0; i <= a.w; ++i) {
    const bool finish = i == a.w;
    const int t = a.t0 + i;
    float* in = i == 0 ? const_cast<float*>(a.alpha) : (((i - 1) & 1) ? a.buf1 : a.buf0);
    float* out = (i & 1) ? a.buf1 : a.buf0;
    const float* prev_best = a.best + ((i + 2) % 3) * b;  // frame i - 1's
    float* cur_best = a.best + (i % 3) * b;
    if (blockIdx.x == 0 && i + 1 < a.w)
      for (int x = threadIdx.x; x < a.b; x += kThreads) a.best[((i + 1) % 3) * b + x] = kNeg;
    int cur_g = -1;
    float m = kNeg;
    for (int64_t u = blockIdx.x; u < units; u += gridDim.x) {
      const int g = static_cast<int>(u / per_group);
      const int st = static_cast<int>(u - static_cast<int64_t>(g) * per_group) * kWarps + warp;
      if (g != cur_g) {  // block-uniform
        if (cur_g >= 0 && !finish) flush_best(red, m, cur_best, cur_g, a.b);
        cur_g = g;
        m = kNeg;
      }
      if (st >= a.s) continue;  // warp-uniform
      const int l = g * 32 + lane;
      const bool valid = l < a.b;
      const int nf = valid ? __ldg(a.num_frames + l) : 0;
      const bool act = !finish && t < nf;  // frame t relaxes this lane
      const bool prev = i > 0 && t - 1 < nf;  // frame t - 1, run here, left raw scores
      const float thr = prev ? __fsub_rn(__ldcg(prev_best + l), a.beam) : 0.f;
      const int64_t at = (static_cast<int64_t>(st) * b + l) * k;
      if (valid && (prev || (!act && !finish))) {
        // the own list of frame t - 1: pruned, its pruned slots' backpointers
        // cleared, captured where the lane ended, copied where it has ended
        float p[KM];
        load_list<KM, VEC>(in + at, k, p);
        if (prev) {
          bool changed = false;
          const int64_t bp_at = (i - 1) * a.frame_tab + at;
#pragma unroll
          for (int q = 0; q < KM; ++q)
            if (q < k && p[q] > kNeg && !(p[q] >= thr)) {
              p[q] = kNeg;
              a.bp_arc[bp_at + q] = -1;
              a.bp_slot[bp_at + q] = 0;
              changed = true;
            }
          if (t == nf) store_list<KM, VEC>(a.alpha_end + at, k, p);
          if (finish && changed) store_list<KM, VEC>(in + at, k, p);
        }
        if (!act && !finish) {
          int none[KM];
#pragma unroll
          for (int q = 0; q < KM; ++q) none[q] = kNone;
          store_list<KM, VEC>(out + at, k, p);
          store_prov<KM, VEC>(a.bp_arc + i * a.frame_tab + at, a.bp_slot + i * a.frame_tab + at,
                              k, none);
        }
      }
      if (!finish && __any_sync(kFull, act)) {
        float v[KM];
        int prov[KM];
        relax<KM, VEC>(a, in, i, st, l, act, i > 0, thr, v, prov);
        if (act) {
          store_list<KM, VEC>(out + at, k, v);
          store_prov<KM, VEC>(a.bp_arc + i * a.frame_tab + at, a.bp_slot + i * a.frame_tab + at, k,
                              prov);
          m = fmaxf(m, v[0]);
        }
      }
    }
    if (!finish) {
      if (cur_g >= 0) flush_best(red, m, cur_best, cur_g, a.b);
      cg::this_grid().sync();
    }
  }
}

// A cooperative launch of the blocks that fit on the card at once (or
// max_blocks of them), striding over the units.
template <int KM, bool VEC>
cudaError_t launch(const K7Args& a, int max_blocks, cudaStream_t stream) {
  const int64_t units = static_cast<int64_t>((a.b + 31) / 32) * ((a.s + kWarps - 1) / kWarps);
  int64_t grid = units;
  if (max_blocks > 0 && grid > max_blocks) grid = max_blocks;
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, nbest_window_kernel<KM, VEC>,
                                                        kThreads, 0);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  const int64_t resident = static_cast<int64_t>(per_sm) * sms;
  if (grid > resident) grid = resident;
  if (grid < 1) return cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {const_cast<K7Args*>(&a)};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(nbest_window_kernel<KM, VEC>),
                                     dim3(static_cast<unsigned>(grid)), dim3(kThreads), args, 0,
                                     stream);
}

bool aligned(const void* p, uintptr_t n) {
  return (reinterpret_cast<uintptr_t>(p) % n) == 0;
}

}  // namespace

// Runs frames t0 .. t0 + w - 1 from ``alpha``; the result of the last frame
// is in buf0 when w is odd, else buf1.  best: [3, b] floats, all -1e30 on
// entry.  max_blocks > 0 caps the grid.  Arc ids must be below 2^27.
extern "C" int vbt_viterbi_nbest(const float* alpha, float* buf0, float* buf1, float* alpha_end,
                                 int* bp_arc, int8_t* bp_slot, float* best, const float* ll,
                                 const int* in_start, const int* src, const int* pdf,
                                 const float* score, const int* arc, const int* num_frames, int t0,
                                 int w, float acwt, float beam, int b, int s, int k, int p,
                                 int max_blocks, void* stream) {
  if (w < 1 || k < 1 || k > 16 || (w > 1 && buf1 == nullptr)) return cudaErrorInvalidValue;
  if (static_cast<int64_t>(b) * s == 0) return 0;
  const K7Args a{alpha, buf0, buf1, alpha_end, bp_arc, bp_slot, best, ll, in_start, src, pdf, score,
                 arc, num_frames, static_cast<int64_t>(p) * b,
                 static_cast<int64_t>(s) * b * k, t0, w, b, s, k, acwt, beam};
  const bool vec = k % 4 == 0 && aligned(alpha, 16) && aligned(buf0, 16) &&
                   aligned(buf1, 16) && aligned(alpha_end, 16) && aligned(bp_arc, 16) &&
                   aligned(bp_slot, 4);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k == 1) return launch<1, false>(a, max_blocks, st);
  if (k == 2) return launch<2, false>(a, max_blocks, st);
  if (k == 4 && vec) return launch<4, true>(a, max_blocks, st);
  if (k <= 4) return launch<4, false>(a, max_blocks, st);
  if (k == 8 && vec) return launch<8, true>(a, max_blocks, st);
  if (k <= 8) return launch<8, false>(a, max_blocks, st);
  if (k == 16 && vec) return launch<16, true>(a, max_blocks, st);
  return launch<16, false>(a, max_blocks, st);
}
