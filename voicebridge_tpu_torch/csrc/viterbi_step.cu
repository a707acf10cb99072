// K3: the exact Viterbi relaxation for Hopper (sm_90a), one frame or a
// window of frames per launch.
//
// Replaces the per-frame step of the XLA scans in the JAX package:
// voicebridge_tpu/ops/decode_core.py (viterbi_scan -> _emit_step,
// emit_value_step and reduce_rows) over the forward plan, and
// voicebridge_tpu/ops/lattice.py (_fb_win_backward -> bwd_frame) over the
// backward plan.  For plan state s and utterance lane b, over the state's
// in-degree rows r in [row_start[s], row_start[s+1]):
//
//   v_r = max_slot(alpha[row_src[r,slot], b] + row_w[r,slot])
//         + acwt * ll_t[row_pdf[r], b]
//   alpha_out[s, b] = max_r v_r,   bp[s, b] = local_row * D + slot
//
// Ties: the first maximal slot within a row, the largest code among maximal
// rows, as the plain version does.  Frames at or past an utterance's length
// keep the old alpha; the frame that ends an utterance writes alpha_end.
// The backward window (lattice phase 2) runs the frames in reverse and first
// replaces its input by beta_eff = (t + 1 == nf ? final_eff : beta), which it
// also stores per frame into the slab that K5 reads.
//
// The work is gathers: each frame reads the alpha rows of all arc sources
// (4 bytes x B per slot; 246 MB of real arcs per frame on the 60k-state /
// 480k-arc graph at B = 128) from an (S+1) x B table held in the 50 MB L2.
//
// Design:
// * One warp per (plan state, 128 lanes); each thread holds 4 consecutive
//   lanes and gathers alpha and ll_t as one float4 (a warp reads one 512-byte
//   row segment) when B % 4 == 0 and the pointers are 16-byte aligned, else
//   as four masked scalars.  The warp loads a chunk of rows' row_src/row_w
//   (32 slots), row_pdf and real-slot counts once, one value a thread, and
//   passes them to all 32 threads by __shfl_sync.
// * D is a template parameter (1..8; 0 = a runtime D for wider rows): a
//   row's gathers are issued together before any is reduced.  For D <= 2
//   (the lattice's backward plan, one real slot in most rows) a row is
//   dispatched on its real-slot count, so no empty slot is issued; wider rows
//   issue every slot under a predicate (their dispatched variants spill).
//   Without backpointers the winning slot is not tracked.
// * Pads once, exactly: a row's pad slots trail its real ones and all read
//   the pad state S with weight NEG_INF, so they share one value,
//   g_pad = alpha[S] + NEG_INF, computed once per frame.  A partial row takes
//   the pad only if g_pad beats its real maximum (slot = n_real); a row that
//   is all padding is worth g_pad + am[row_pdf], which reproduces the full
//   evaluation bit for bit.  The acoustic score of a row is gathered only
//   when its pdf differs from the previous row's.  The own state's input is
//   read only where a lane is inactive or the slab needs it.
// * A window of W frames is one cooperative launch sized to the blocks that
//   fit on the card at once: blocks stride over the units, and
//   cooperative_groups' grid sync separates the frames.  alpha ping-pongs
//   between two buffers; each frame writes its own backpointer or slab
//   slice.  Gathers of the ping-pong buffers go through L2 (__ldcg), since
//   other blocks wrote them in this launch; read-only inputs use __ldg.
// * Measured on the H100 (PERF.md): neither the bytes alone (half the lanes
//   take 92 % of the time) nor the chain of index loads alone (prefetching
//   the next state's indices made it slower) bound it at full width, at 16
//   warps an SM (128 registers; fewer spill).  Copying each block's sources
//   into shared memory, with states taken in graph order, was slower.
// * The adds and the multiply use __fadd_rn and __fmul_rn so no FMA
//   contraction changes the rounding against the plain version: equal inputs
//   give bit-equal scores and equal tie decisions.  Offsets that scale with
//   B, R or D are 64-bit.

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

struct K3Args {
  const float* alpha;       // [S+1, B] input of the first frame run
  float* buf0;              // [S+1, B] output of frames 0, 2, 4, ... of the run
  float* buf1;              // [S+1, B] output of frames 1, 3, ... (W > 1)
  float* alpha_end;         // [S+1, B] updated in place, or null
  void* bp;                 // [W, S+1, B] uint8 / int16 codes, or null
  const float* ll;          // [W, P, B]
  const int* row_start;     // [S+2]
  const int* row_src;       // [R * D]
  const float* row_w;       // [R * D]
  const int* row_pdf;       // [R]
  const uint8_t* row_real;  // [R] real slots per row
  const int* num_frames;    // [B]
  const float* final_eff;   // [S+1, B] backward window, or null
  float* slab;              // [W, S+1, B] beta_eff per frame, or null
  int64_t frame_ll;         // P * B
  int t0, w, s1, b, d, bp_bytes, reverse;
  float acwt;
};

// 4 lanes from p: one float4 (VEC), else nl masked scalars.  Through L2 only.
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

// The same for inputs that no thread writes during the launch.
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

template <bool VEC, typename BP>
__device__ __forceinline__ void store_codes(BP* p, int nl, const int (&c)[4]) {
  if (VEC && sizeof(BP) == 1) {
    if (nl > 0)
      *reinterpret_cast<uchar4*>(p) = make_uchar4(static_cast<uint8_t>(c[0]), static_cast<uint8_t>(c[1]),
                                                  static_cast<uint8_t>(c[2]), static_cast<uint8_t>(c[3]));
  } else if (VEC) {
    if (nl > 0)
      *reinterpret_cast<short4*>(p) = make_short4(static_cast<short>(c[0]), static_cast<short>(c[1]),
                                                  static_cast<short>(c[2]), static_cast<short>(c[3]));
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < nl) p[j] = static_cast<BP>(c[j]);
  }
}

// The lanes of one thread in one frame.
struct Lanes {
  int l0, nl;           // first lane, lanes held (0..4)
  bool act[4], ends[4];  // t < nf, t + 1 == nf
  bool any_act, all_act, sel;
};

__device__ __forceinline__ Lanes lanes_of(const K3Args& a, int l0, int t) {
  Lanes ln;
  ln.l0 = l0;
  ln.nl = max(0, min(4, a.b - l0));
  ln.any_act = false;
  ln.all_act = true;
  bool any_end = false;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int nf = j < ln.nl ? __ldg(a.num_frames + l0 + j) : 0;
    ln.act[j] = t < nf;
    ln.ends[j] = t + 1 == nf;
    ln.any_act |= ln.act[j];
    ln.all_act &= ln.act[j] || j >= ln.nl;
    any_end |= ln.ends[j];
  }
  ln.sel = a.final_eff != nullptr && any_end;
  return ln;
}

// Input of the frame at state src: alpha, or in the backward window
// beta_eff, which takes final_eff in the lanes that end at t + 1.
template <bool VEC>
__device__ __forceinline__ void gather(const K3Args& a, const float* in, int64_t src,
                                       const Lanes& ln, float (&x)[4]) {
  load_cg<VEC>(in + src * a.b + ln.l0, ln.nl, x);
  if (ln.sel) {
    float f[4];
    load_ro<VEC>(a.final_eff + src * a.b + ln.l0, ln.nl, f);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (ln.ends[j]) x[j] = f[j];
  }
}

template <bool VEC>
__device__ __forceinline__ void pad_value(const K3Args& a, const float* in, const Lanes& ln,
                                          float (&gp)[4]) {
  gather<VEC>(a, in, a.s1 - 1, ln, gp);
#pragma unroll
  for (int j = 0; j < 4; ++j) gp[j] = __fadd_rn(gp[j], kNegInf);
}

// One warp-wide chunk of a state's rows: slot ``lane`` of the chunk's
// row_src/row_w, and row ``lane``'s pdf and real-slot count.
struct Chunk {
  int src, pdf, real;
  float w;
};

template <int D>
__device__ __forceinline__ Chunk load_chunk(const K3Args& a, int rb, int r1, int lane) {
  constexpr int kRows = 32 / D;
  const int nr = min(kRows, r1 - rb);
  Chunk c{0, 0, 0, 0.f};
  if (lane < nr * D) {
    c.src = __ldg(a.row_src + static_cast<int64_t>(rb) * D + lane);
    c.w = __ldg(a.row_w + static_cast<int64_t>(rb) * D + lane);
  }
  if (lane < nr) {
    c.pdf = __ldg(a.row_pdf + rb + lane);
    c.real = __ldg(a.row_real + rb + lane);
  }
  return c;
}

// Running maximum of a state over its rows (the plain version's tie rule).
struct Best {
  float v[4];
  int code[4];
};

template <bool CODES = true>
__device__ __forceinline__ void take_row(Best& best, bool first, const float (&v)[4],
                                         const int (&slot)[4], int base) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (first || v[j] >= best.v[j]) {
      best.v[j] = v[j];
      if (CODES) best.code[j] = base + slot[j];
    }
}

// The state's result: the relaxation where the lane is active, else its
// input; alpha_end where the utterance ends; the backpointer codes.
template <bool VEC>
__device__ __forceinline__ void finish(const K3Args& a, float* out, int s, int i,
                                       const Lanes& ln, const Best& best, const float (&self)[4]) {
  const int64_t b = a.b;
  float res[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) res[j] = ln.act[j] ? best.v[j] : self[j];
  store4<VEC>(out + s * b + ln.l0, ln.nl, res);
  if (a.alpha_end != nullptr) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (ln.ends[j]) a.alpha_end[s * b + ln.l0 + j] = res[j];
  }
  const int64_t at = static_cast<int64_t>(i) * a.s1 * b + s * b + ln.l0;
  if (a.bp_bytes == 1)
    store_codes<VEC>(static_cast<uint8_t*>(a.bp) + at, ln.nl, best.code);
  else if (a.bp_bytes == 2)
    store_codes<VEC>(static_cast<int16_t*>(a.bp) + at, ln.nl, best.code);
}

// A row with N real slots (1 <= N <= D): the row's N gathers are issued
// together, then reduced.  Its sources and weights are slots base .. base+N-1
// of the warp's chunk.  Without CODES only the value is kept.
template <int N, int D, bool VEC, bool CODES>
__device__ __forceinline__ void real_row(const K3Args& a, const float* in, const Lanes& ln,
                                         const Chunk& c, int base, const float (&gp)[4],
                                         float (&mx)[4], int (&slot)[4]) {
  float g[N][4];
#pragma unroll
  for (int k = 0; k < N; ++k) gather<VEC>(a, in, __shfl_sync(kFull, c.src, base + k), ln, g[k]);
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const float w = __shfl_sync(kFull, c.w, base + k);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float x = __fadd_rn(g[k][j], w);
      if (k == 0 || x > mx[j]) {
        mx[j] = x;
        if (CODES) slot[j] = k;
      }
    }
  }
  if (N < D) {  // the pad slots: one value, taken only if it beats the real ones
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (gp[j] > mx[j]) {
        mx[j] = gp[j];
        if (CODES) slot[j] = N;
      }
  }
}

// A row of up to D real slots (nreal, warp-uniform): every slot is issued
// under a predicate.  A row that is all padding is worth g_pad (slot 0).
template <int D, bool VEC, bool CODES>
__device__ __forceinline__ void any_row(const K3Args& a, const float* in, const Lanes& ln,
                                        const Chunk& c, int base, int nreal,
                                        const float (&gp)[4], float (&mx)[4], int (&slot)[4]) {
  float g[D][4];
#pragma unroll
  for (int k = 0; k < D; ++k) {
    const int src = __shfl_sync(kFull, c.src, base + k);
    if (k < nreal) gather<VEC>(a, in, src, ln, g[k]);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    mx[j] = gp[j];
    slot[j] = 0;
  }
#pragma unroll
  for (int k = 0; k < D; ++k) {
    const float w = __shfl_sync(kFull, c.w, base + k);
    if (k < nreal) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float x = __fadd_rn(g[k][j], w);
        if (k == 0 || x > mx[j]) {
          mx[j] = x;
          if (CODES) slot[j] = k;
        }
      }
    }
  }
  if (nreal > 0 && nreal < D) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (gp[j] > mx[j]) {
        mx[j] = gp[j];
        if (CODES) slot[j] = nreal;
      }
  }
}

// Dispatch on the row's real-slot count (warp-uniform), so that no slot
// beyond it is issued; a row that is all padding is worth g_pad (slot 0).
// Used for D <= 2: for wider rows the inlined variants spill.
template <int D, bool VEC, bool CODES, int N = D>
__device__ __forceinline__ void row_by_count(const K3Args& a, const float* in, const Lanes& ln,
                                             const Chunk& c, int base, int nreal,
                                             const float (&gp)[4], float (&mx)[4],
                                             int (&slot)[4]) {
  if constexpr (N == 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      mx[j] = gp[j];
      slot[j] = 0;
    }
  } else {
    if (nreal == N)
      real_row<N, D, VEC, CODES>(a, in, ln, c, base, gp, mx, slot);
    else
      row_by_count<D, VEC, CODES, N - 1>(a, in, ln, c, base, nreal, gp, mx, slot);
  }
}

// One (state, 128-lane group) of one frame.  Called by all 32 threads of a
// warp: the row loops are warp-uniform.
template <int D, bool VEC, bool CODES>
__device__ __forceinline__ void relax_unit(const K3Args& a, const float* in, float* out,
                                           const float* ll_t, int s, int i, const Lanes& ln,
                                           const float (&gp)[4]) {
  constexpr int kRows = 32 / D;
  const int lane = threadIdx.x & 31;
  float self[4] = {0.f, 0.f, 0.f, 0.f};
  if (a.slab != nullptr || !ln.all_act) gather<VEC>(a, in, s, ln, self);
  if (a.slab != nullptr)
    store4<VEC>(a.slab + static_cast<int64_t>(i) * a.s1 * a.b + s * static_cast<int64_t>(a.b) +
                    ln.l0,
                ln.nl, self);
  Best best;
  if (!CODES && !__any_sync(kFull, ln.any_act)) {
    finish<VEC>(a, out, s, i, ln, best, self);  // no lane of the warp moves
    return;
  }
  const int r0 = __ldg(a.row_start + s);
  const int r1 = __ldg(a.row_start + s + 1);
  int am_pdf = -1;  // the pdf whose acoustic score was gathered last
  float am[4];
  for (int rb = r0; rb < r1; rb += kRows) {
    const Chunk c = load_chunk<D>(a, rb, r1, lane);
    const int nr = min(kRows, r1 - rb);
    for (int rr = 0; rr < nr; ++rr) {
      const int pdf = __shfl_sync(kFull, c.pdf, rr);
      const int nreal = __shfl_sync(kFull, c.real, rr);
      if (pdf != am_pdf) {
        load_ro<VEC>(ll_t + static_cast<int64_t>(pdf) * a.b + ln.l0, ln.nl, am);
        am_pdf = pdf;
      }
      float v[4];
      int slot[4];
      if constexpr (D <= 2)
        row_by_count<D, VEC, CODES>(a, in, ln, c, rr * D, nreal, gp, v, slot);
      else
        any_row<D, VEC, CODES>(a, in, ln, c, rr * D, nreal, gp, v, slot);
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = __fadd_rn(v[j], __fmul_rn(am[j], a.acwt));
      take_row<CODES>(best, rb + rr == r0, v, slot, (rb + rr - r0) * D);
    }
  }
  finish<VEC>(a, out, s, i, ln, best, self);
}

// Runtime D (rows wider than 8 slots): the row's indices are read directly
// (one broadcast load a slot), one slot at a time.
template <bool VEC>
__device__ __forceinline__ void relax_unit_wide(const K3Args& a, const float* in, float* out,
                                                const float* ll_t, int s, int i,
                                                const Lanes& ln, const float (&gp)[4]) {
  const int d = a.d;
  float self[4] = {0.f, 0.f, 0.f, 0.f};
  if (a.slab != nullptr || !ln.all_act) gather<VEC>(a, in, s, ln, self);
  if (a.slab != nullptr)
    store4<VEC>(a.slab + static_cast<int64_t>(i) * a.s1 * a.b + s * static_cast<int64_t>(a.b) +
                    ln.l0,
                ln.nl, self);
  Best best;
  if (a.bp == nullptr && !__any_sync(kFull, ln.any_act)) {
    finish<VEC>(a, out, s, i, ln, best, self);
    return;
  }
  const int r0 = __ldg(a.row_start + s);
  const int r1 = __ldg(a.row_start + s + 1);
  for (int r = r0; r < r1; ++r) {
    const int nreal = __ldg(a.row_real + r);
    const int64_t base_slot = static_cast<int64_t>(r) * d;
    float am[4], v[4];
    int slot[4];
    load_ro<VEC>(ll_t + static_cast<int64_t>(__ldg(a.row_pdf + r)) * a.b + ln.l0, ln.nl, am);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = gp[j];
      slot[j] = 0;
    }
    for (int k = 0; k < nreal; ++k) {
      float g[4];
      gather<VEC>(a, in, __ldg(a.row_src + base_slot + k), ln, g);
      const float wk = __ldg(a.row_w + base_slot + k);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float x = __fadd_rn(g[j], wk);
        if (k == 0 || x > v[j]) {
          v[j] = x;
          slot[j] = k;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (nreal > 0 && nreal < d && gp[j] > v[j]) {
        v[j] = gp[j];
        slot[j] = nreal;
      }
      v[j] = __fadd_rn(v[j], __fmul_rn(am[j], a.acwt));
    }
    take_row(best, r == r0, v, slot, (r - r0) * d);
  }
  finish<VEC>(a, out, s, i, ln, best, self);
}

template <int D, bool VEC, bool CODES>
__global__ void __launch_bounds__(kThreads, 2) viterbi_window_kernel(const K3Args a) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int groups = (a.b + kLanesPerWarp - 1) / kLanesPerWarp;
  const int64_t units = static_cast<int64_t>(a.s1) * groups;
  for (int k = 0; k < a.w; ++k) {
    const int i = a.reverse ? a.w - 1 - k : k;
    const int t = a.t0 + i;
    const float* in = k == 0 ? a.alpha : ((k & 1) ? a.buf0 : a.buf1);
    float* out = (k & 1) ? a.buf1 : a.buf0;
    const float* ll_t = a.ll + i * a.frame_ll;
    // a thread's lanes and the pad value change only with the lane group
    int group = -1;
    Lanes ln;
    float gp[4];
    for (int64_t u = static_cast<int64_t>(blockIdx.x) * kWarps + warp; u < units;
         u += static_cast<int64_t>(gridDim.x) * kWarps) {
      const int s = static_cast<int>(u / groups);
      const int g = static_cast<int>(u - static_cast<int64_t>(s) * groups);
      if (g != group) {
        group = g;
        ln = lanes_of(a, g * kLanesPerWarp + lane * 4, t);
        pad_value<VEC>(a, in, ln, gp);
      }
      if constexpr (D > 0)
        relax_unit<D, VEC, CODES>(a, in, out, ll_t, s, i, ln, gp);
      else
        relax_unit_wide<VEC>(a, in, out, ll_t, s, i, ln, gp);
    }
    if (k + 1 < a.w) cg::this_grid().sync();
  }
}

// W == 1: an ordinary launch over all units (or max_blocks of them, striding).
// W > 1: a cooperative launch of the blocks that fit on the card at once.
template <int D, bool VEC, bool CODES>
cudaError_t launch(const K3Args& a, int max_blocks, cudaStream_t stream) {
  const int groups = (a.b + kLanesPerWarp - 1) / kLanesPerWarp;
  int64_t grid = (static_cast<int64_t>(a.s1) * groups + kWarps - 1) / kWarps;
  if (max_blocks > 0 && grid > max_blocks) grid = max_blocks;
  if (a.w == 1) {
    if (grid > 0x7fffffff) return cudaErrorInvalidValue;
    viterbi_window_kernel<D, VEC, CODES><<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(a);
    return cudaGetLastError();
  }
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, viterbi_window_kernel<D, VEC, CODES>,
                                                        kThreads, 0);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  const int64_t resident = static_cast<int64_t>(per_sm) * sms;
  if (grid > resident) grid = resident;
  if (grid < 1) return cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {const_cast<K3Args*>(&a)};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(viterbi_window_kernel<D, VEC, CODES>),
                                     dim3(static_cast<unsigned>(grid)), dim3(kThreads), args, 0,
                                     stream);
}

template <bool VEC, bool CODES>
cudaError_t dispatch(const K3Args& a, int max_blocks, cudaStream_t stream) {
  switch (a.d) {
    case 1: return launch<1, VEC, CODES>(a, max_blocks, stream);
    case 2: return launch<2, VEC, CODES>(a, max_blocks, stream);
    case 3: return launch<3, VEC, CODES>(a, max_blocks, stream);
    case 4: return launch<4, VEC, CODES>(a, max_blocks, stream);
    case 5: return launch<5, VEC, CODES>(a, max_blocks, stream);
    case 6: return launch<6, VEC, CODES>(a, max_blocks, stream);
    case 7: return launch<7, VEC, CODES>(a, max_blocks, stream);
    case 8: return launch<8, VEC, CODES>(a, max_blocks, stream);
    default: return launch<0, VEC, CODES>(a, max_blocks, stream);
  }
}

bool aligned(const void* p, uintptr_t n) {
  return (reinterpret_cast<uintptr_t>(p) % n) == 0;
}

}  // namespace

// Runs frames t0 .. t0 + w - 1 (in reverse when ``reverse``) from ``alpha``;
// the result of the last frame run is in buf0 when w is odd, else buf1.
// bp_bytes: 0 = no backpointers (bp may be null), 1 = uint8, 2 = int16.
// final_eff and slab (both or neither) select the backward window.
// max_blocks > 0 caps the grid (the stride loop then covers every state).
extern "C" int vbt_viterbi_step(const float* alpha, float* buf0, float* buf1, float* alpha_end,
                                void* bp, int bp_bytes, const float* ll, const int* row_start,
                                const int* row_src, const float* row_w, const int* row_pdf,
                                const uint8_t* row_real, const int* num_frames,
                                const float* final_eff, float* slab, int t0, int w, float acwt,
                                int s1, int b, int p, int d, int reverse, int max_blocks,
                                void* stream) {
  if (w < 1 || d < 1 || bp_bytes < 0 || bp_bytes > 2 || (bp_bytes > 0) != (bp != nullptr) ||
      (final_eff == nullptr) != (slab == nullptr) || (w > 1 && buf1 == nullptr))
    return cudaErrorInvalidValue;
  if (static_cast<int64_t>(s1) * b == 0) return 0;
  const K3Args a{alpha, buf0, buf1, alpha_end, bp, ll, row_start, row_src, row_w, row_pdf,
                 row_real, num_frames, final_eff, slab, static_cast<int64_t>(p) * b, t0, w, s1,
                 b, d, bp_bytes, reverse, acwt};
  const bool vec = b % 4 == 0 && aligned(alpha, 16) && aligned(buf0, 16) && aligned(buf1, 16) &&
                   aligned(ll, 16) && aligned(final_eff, 16) && aligned(slab, 16) &&
                   aligned(bp, 4 * (bp_bytes > 0 ? bp_bytes : 1));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bp != nullptr)
    return vec ? dispatch<true, true>(a, max_blocks, s) : dispatch<false, true>(a, max_blocks, s);
  return vec ? dispatch<true, false>(a, max_blocks, s) : dispatch<false, false>(a, max_blocks, s);
}
