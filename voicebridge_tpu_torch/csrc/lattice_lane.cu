// The lane-major lattice forward-backward for Hopper (sm_90a), lanes minor.
//
// Replaces the XLA program voicebridge_tpu/ops/lattice.py
// lattice_forward_backward (with _window_fb): two arc-parallel max-plus
// passes over a shared graph with the decoder's beam and max_active prune in
// the forward.  Per lane b and frame t:
//
//   forward   score[a] = (alpha[src a] + w a) + fl(ll[t, pdf a] * acwt)
//             r[d]     = max(NEG_INF, max over arcs a into d of score[a])
//             alpha'[d] = r[d] if r[d] >= best - beam and, with max_active,
//             r[d] >= the max_active-th largest beam-pruned score (every
//             state tied at that value survives), else NEG_INF; lanes with
//             t >= nf keep alpha; alpha_at_end is alpha after frame nf - 1.
//   backward  beta_eff = (t + 1 == nf) ? final_eff : beta
//             tail[a]  = (fl(ll * acwt) + w a) + beta_eff[dst a]
//             keep[a]  = alpha_t[src a] + tail[a] >= total_best - lattice_beam
//                        and t < nf
//             beta'[s] = max(NEG_INF, max over arcs a out of s of tail[a])
//             lanes with t >= nf keep beta.
//
// Adds and the multiply are __fadd_rn / __fmul_rn in the JAX package's order,
// and a max is exact in any order, so the kernels give the plain version's
// scores and survivor bits exactly, whatever the split of a state's arcs.
//
// The work is gathers of 128-lane row segments: per frame and pass each arc
// reads its source's (forward) or destination's (backward) scores and its
// pdf's log-likelihoods, from tables held in the 50 MB L2.  Design:
// * Lanes minor: scores [S, B], log-likelihoods [T, P, B].  A warp takes one
//   piece of a state's arcs over up to 128 lanes, 4 a thread, as one float4
//   when B % 4 == 0 (else masked scalars).  It loads a chunk of the piece's
//   arcs (source or destination, weight, pdf; 32 arcs, one a thread) once
//   and passes them round by __shfl_sync, so the graph is read once a frame
//   and pass, not once a lane; four arcs' gathers, and their log-likelihood
//   rows where the pdf changes, are issued before any is reduced (a state's
//   in-arcs are grouped by pdf on the host).
// * Hubs: a state of more arcs than a piece holds (the host's plan) is split
//   into pieces that separate warps walk; their maxima meet by atomicMax on
//   an ordered key ([hubs, B] scratch), and after a grid sync a short phase
//   writes the hubs' scores.  Graphs without hubs skip it.
// * One cooperative launch per window and pass: blocks stride over (piece,
//   128-lane group) units, cooperative_groups' grid sync separates the
//   frames.  Buffers written in the launch are read through L2 (__ldcg),
//   read-only inputs through __ldg.
// * The prune on read: the forward stores each frame's unpruned maxima
//   seq[i+1] and a cut per lane, max(best - beam, k-th score), so that
//   alpha = (seq >= cut) ? seq : NEG_INF; the next frame, the backward and
//   alpha_at_end apply it when they read.  The best of a lane comes from the
//   warps' maxima, reduced in shared memory and by atomicMax on an ordered
//   key; a frame without max_active or hubs costs one grid sync.  With
//   max_active the k-th largest score is an exact radix select over the
//   float bits (4 passes of 8 bits, a grid sync after each pass's histogram
//   and after each lane's selection), reading the [S, B] table by rows; a
//   block counts a lane group's histograms in shared memory (16-bit
//   counters, [256 bins, 128 lanes]) and adds the bins it touched to the
//   [B, 256] histogram.  The launch's last phase applies the cut of the
//   window's last frame in place and writes alpha_at_end.
// * Survivor bits: the backward launch zeroes each frame's [B, row] slice of
//   the packed mask one phase ahead (16-byte stores), and sets the
//   survivors' bits (np.packbits order, rows padded to whole words by the
//   caller) with atomicOr on the 32-bit word of their byte: a thread keeps
//   its lanes' bits while the walk stays in one byte (the CSR by source keeps
//   arc order), one atomic per (byte, lane) with a survivor.  The zero stream
//   is the function's one unavoidable write, 7.68 GB at full width;
//   survivors are sparse at a lattice beam (6.6 a frame and lane at full
//   width), so the atomics are few; where most arcs survive they cost most.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLanesPerWarp = 128;
constexpr int kUnroll = 4;  // arcs whose gathers are issued together
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNeg = -1.0e30f;
// the radix select: 4 digits of 8 bits from the top
constexpr int kRadixBits = 8;
constexpr int kBins = 1 << kRadixBits;
constexpr int kPasses = 32 / kRadixBits;
constexpr int kHistWords = kBins * kLanesPerWarp / 2;  // 16-bit counters, two a word
constexpr int kMaxBlockCount = 65535;                  // a 16-bit counter's range
constexpr int kRows = 4;  // states whose scores a histogram pass loads together

// orderable key: a larger float has a larger key
__device__ __forceinline__ unsigned key_of(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float float_of(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

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

__device__ __forceinline__ float cut_value(float x, float cut) { return x >= cut ? x : kNeg; }

// A grid-stride walk over ``n`` items times the lane groups, a warp an item:
// unit u is item u / groups, lane group u % groups.
struct Walk {
  int64_t first, step, units;
  int groups;
};

__device__ __forceinline__ Walk walk_of(int64_t n, int b) {
  Walk w;
  w.groups = (b + kLanesPerWarp - 1) / kLanesPerWarp;
  w.units = n * w.groups;
  w.first = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  w.step = static_cast<int64_t>(gridDim.x) * kWarps;
  return w;
}

__device__ __forceinline__ int first_lane(int g) {
  return g * kLanesPerWarp + (threadIdx.x & 31) * 4;
}

// The entries of a CSR row: the state at the arc's other end (source in the
// forward, destination in the backward), weight, pdf, and arc id (or null).
struct Arcs {
  const int* node;
  const float* score;
  const int* pdf;
  const int* arc;
};

// Up to 32 entries of a CSR, one a thread.
struct Chunk {
  int node, pdf, arc;
  float w;
};

__device__ __forceinline__ Chunk load_chunk(const Arcs& arcs, int lo, int hi) {
  const int e = lo + (threadIdx.x & 31);
  Chunk c{0, 0, 0, 0.f};
  if (e < hi) {
    c.node = __ldg(arcs.node + e);
    c.w = __ldg(arcs.score + e);
    c.pdf = __ldg(arcs.pdf + e);
    if (arcs.arc != nullptr) c.arc = __ldg(arcs.arc + e);
  }
  return c;
}

// Walks entries [lo, hi) of a CSR, ``c`` holding the first 32:
// ``gather(node, x)`` loads the thread's 4 lanes of the row the arc reads
// and the pdf's log-likelihoods are loaded (where the pdf changes), both
// issued for kUnroll arcs before any is used; then ``visit(x, am, w, arc)``
// per arc, am = fl(ll[pdf] * acwt) of the thread's lanes.  Called by all 32
// threads of a warp.
template <bool VEC, class Gather, class Visit>
__device__ __forceinline__ void walk_arcs(const Arcs& arcs, int lo, int hi, Chunk c, int l0,
                                          int nl, const float* ll_t, int64_t b, float acwt,
                                          Gather gather, Visit visit) {
  int am_pdf = -1;  // the pdf whose log-likelihoods are in am
  float am[4] = {0.f, 0.f, 0.f, 0.f};
  for (int rb = lo; rb < hi; rb += 32) {
    if (rb > lo) c = load_chunk(arcs, rb, hi);
    const int n = min(32, hi - rb);
    for (int k = 0; k < n; k += kUnroll) {
      float x[kUnroll][4], m[kUnroll][4];
      int pdf[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int node = __shfl_sync(kFull, c.node, (k + u) & 31);
        pdf[u] = __shfl_sync(kFull, c.pdf, (k + u) & 31);
        if (k + u < n) {
          gather(node, x[u]);
          if (pdf[u] != (u == 0 ? am_pdf : pdf[u - 1]))
            load_ro<VEC>(ll_t + pdf[u] * b + l0, nl, m[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float w = __shfl_sync(kFull, c.w, (k + u) & 31);
        const int arc = __shfl_sync(kFull, c.arc, (k + u) & 31);
        if (k + u < n) {
          if (pdf[u] != am_pdf) {
#pragma unroll
            for (int j = 0; j < 4; ++j) am[j] = __fmul_rn(m[u][j], acwt);
            am_pdf = pdf[u];
          }
          visit(x[u], am, w, arc);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

struct FwdArgs {
  float* seq;           // [W+1, S, B]: seq[0] alpha before t0 (pruned); fills seq[1..W]
  float* cut;           // [W+1, B] out: seq[i]'s cut (-inf for seq[0] and seq[W])
  float* at_end;        // [S, B] updated in place, or null
  unsigned* best;       // [W+1, B] scratch: ordered key of frame i - 1's best score
  float* kth;           // [W+1, B] scratch: frame i - 1's k-th score (max_active)
  unsigned* hist;       // [B, kBins] scratch (max_active)
  unsigned* sel;        // [2, B] scratch (max_active): prefix, remaining rank
  unsigned* hubkey;     // [hubs, B] scratch: the hubs' maxima as ordered keys
  const float* ll;      // [T, P, B]
  const int4* piece;    // [pieces] (state, lo, hi, hub slot or -1), CSR by destination
  const int* hub;       // [hubs] the hubs' states
  const int* in_src;    // [A]
  const float* in_score;
  const int* in_pdf;
  const int* nf;        // [B]
  int64_t frame_ll;     // P * B
  int t0, w, s, b, max_active, pieces, hubs;
  float acwt, beam;
};

__device__ __forceinline__ Arcs fwd_arcs(const FwdArgs& a) {
  return Arcs{a.in_src, a.in_score, a.in_pdf, nullptr};
}

// The cut of seq[i] for lane l: -inf where seq[i] was not relaxed (i == 0, or
// the lane had ended), else best - beam, or with max_active the larger of it
// and the k-th score.
template <bool SELECT>
__device__ __forceinline__ float cut_of(const FwdArgs& a, int i, int l) {
  if (i == 0 || a.t0 + i - 1 >= __ldg(a.nf + l)) return -INFINITY;
  const int64_t at = static_cast<int64_t>(i) * a.b + l;
  const float thr = __fsub_rn(float_of(__ldcg(a.best + at)), a.beam);
  return SELECT ? fmaxf(thr, __ldcg(a.kth + at)) : thr;
}

// A thread's 4 lanes in one frame of the forward.
struct FwdLanes {
  int l0, nl;
  bool act[4];   // t < nf
  float cut[4];  // of the input seq[i]
  bool any_act, all_act;
};

template <bool SELECT>
__device__ __forceinline__ FwdLanes fwd_lanes(const FwdArgs& a, int g, int i) {
  FwdLanes ln;
  ln.l0 = first_lane(g);
  ln.nl = max(0, min(4, a.b - ln.l0));
  ln.any_act = false;
  ln.all_act = true;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool in = j < ln.nl;
    ln.act[j] = in && a.t0 + i < __ldg(a.nf + ln.l0 + j);
    ln.cut[j] = in ? cut_of<SELECT>(a, i, ln.l0 + j) : -INFINITY;
    ln.any_act |= ln.act[j];
    ln.all_act &= ln.act[j] || !in;
  }
  return ln;
}

// The state's (cut) input, for the lanes that have ended.
template <bool VEC>
__device__ __forceinline__ void fwd_self(const float* in, int64_t s, int64_t b,
                                         const FwdLanes& ln, float (&self)[4]) {
  load_cg<VEC>(in + s * b + ln.l0, ln.nl, self);
#pragma unroll
  for (int j = 0; j < 4; ++j) self[j] = cut_value(self[j], ln.cut[j]);
}

// One (piece, lane group) of frame i: the relaxation r of the piece's state
// where the lane is active, else its input, stored in ``out``; a hub's piece
// instead takes its maximum into the hub's keys.  The running best of the
// thread's lanes is kept in bacc.  All 32 threads of the warp call it.
template <bool VEC>
__device__ __forceinline__ void relax_unit(const FwdArgs& a, const float* in, float* out,
                                           const float* ll_t, const int4 pc, const Chunk& c,
                                           const FwdLanes& ln, float (&bacc)[4]) {
  const int64_t b = a.b;
  float self[4] = {0.f, 0.f, 0.f, 0.f};
  if (pc.w < 0 && !ln.all_act) fwd_self<VEC>(in, pc.x, b, ln, self);
  if (!__any_sync(kFull, ln.any_act)) {
    if (pc.w < 0) store4<VEC>(out + pc.x * b + ln.l0, ln.nl, self);
    return;
  }
  float v[4] = {kNeg, kNeg, kNeg, kNeg};
  walk_arcs<VEC>(
      fwd_arcs(a), pc.y, pc.z, c, ln.l0, ln.nl, ll_t, b, a.acwt,
      [&](int src, float (&x)[4]) { load_cg<VEC>(in + src * b + ln.l0, ln.nl, x); },
      [&](const float (&x)[4], const float (&am)[4], float w, int) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          v[j] = fmaxf(v[j], __fadd_rn(__fadd_rn(cut_value(x[j], ln.cut[j]), w), am[j]));
      });
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (ln.act[j]) bacc[j] = fmaxf(bacc[j], v[j]);
  if (pc.w >= 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (ln.act[j]) atomicMax(a.hubkey + pc.w * b + ln.l0 + j, key_of(v[j]));
    return;
  }
  float res[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) res[j] = ln.act[j] ? v[j] : self[j];
  store4<VEC>(out + pc.x * b + ln.l0, ln.nl, res);
}

// The thread's lane maxima into the block's keys (shared memory).
__device__ __forceinline__ void flush_best(unsigned* sbest, int g, const FwdLanes& ln,
                                           float (&bacc)[4]) {
  const int base = first_lane(g);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (ln.act[j]) atomicMax(sbest + base + j, key_of(bacc[j]));
    bacc[j] = kNeg;
  }
}

// One pass of the radix select of frame i (values in seq[i+1]): every active
// lane's histogram of the key digit at ``pass`` of the keys that match its
// prefix, a lane group at a time in shared memory, then (after a grid sync)
// a warp per lane picks the bin that holds the k-th largest key.  Ends with
// a grid sync.
template <bool VEC>
__device__ void select_pass(const FwdArgs& a, cg::grid_group& grid, unsigned* sh, int i,
                            int pass) {
  const int shift = 32 - kRadixBits * (pass + 1);
  const unsigned mask = pass == 0 ? 0u : (0xffffffffu << (32 - kRadixBits * pass));
  const int t = a.t0 + i;
  const int64_t b = a.b;
  const float* v_in = a.seq + static_cast<int64_t>(i + 1) * a.s * b;
  const Walk st = walk_of(a.s, a.b);
  const int lane = threadIdx.x & 31;
  for (int g = 0; g < st.groups; ++g) {
    const int l0 = first_lane(g);
    const int nl = max(0, min(4, a.b - l0));
    bool act[4], any = false;
    float thr[4];
    unsigned prefix[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      act[j] = j < nl && t < __ldg(a.nf + l0 + j);
      thr[j] = act[j] ? __fsub_rn(float_of(__ldcg(a.best + (i + 1) * b + l0 + j)), a.beam) : 0.f;
      prefix[j] = act[j] && pass > 0 ? __ldcg(a.sel + l0 + j) : 0u;
      any |= act[j];
    }
    if (__any_sync(kFull, any)) {
      for (int64_t s0 = st.first; s0 < a.s; s0 += kRows * st.step) {
        float v[kRows][4];  // kRows states' loads issued before any is counted
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          if (s0 + r * st.step < a.s) load_cg<VEC>(v_in + (s0 + r * st.step) * b + l0, nl, v[r]);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (s0 + r * st.step >= a.s) break;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const unsigned k = key_of(cut_value(v[r][j], thr[j]));
            if (!act[j] || (k & mask) != prefix[j]) continue;
            const unsigned bin = (k >> shift) & (kBins - 1);
            atomicAdd(sh + bin * (kLanesPerWarp / 2) + lane * 2 + j / 2, 1u << (16 * (j & 1)));
          }
        }
      }
    }
    __syncthreads();
    for (int k = threadIdx.x; k < kHistWords; k += kThreads) {
      const unsigned word = sh[k];
      if (word == 0) continue;
      sh[k] = 0;
      const int bin = k / (kLanesPerWarp / 2);
      const int64_t l = g * kLanesPerWarp + 2 * (k % (kLanesPerWarp / 2));
      if (word & 0xffffu) atomicAdd(a.hist + l * kBins + bin, word & 0xffffu);
      if (word >> 16) atomicAdd(a.hist + (l + 1) * kBins + bin, word >> 16);
    }
    __syncthreads();
  }
  grid.sync();
  // a warp per lane: the largest bin d whose keys and those above reach the
  // remaining rank (the plain scan from the top bin down), its histogram
  // cleared; thread q holds bins [q kPer, (q + 1) kPer)
  constexpr int kPer = kBins / 32;
  for (int64_t l = st.first; l < a.b; l += st.step) {
    if (t >= __ldg(a.nf + l)) continue;
    unsigned* h = a.hist + l * kBins + lane * kPer;
    unsigned c[kPer];
    unsigned local = 0;
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      c[q] = __ldcg(h + q);
      local += c[q];
      h[q] = 0;
    }
    unsigned incl = local;  // keys in bins >= kPer * lane
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned y = __shfl_down_sync(kFull, incl, o);
      if (lane + o < 32) incl += y;
    }
    const unsigned rank = pass == 0 ? static_cast<unsigned>(a.max_active) : __ldcg(a.sel + b + l);
    const unsigned pre = pass == 0 ? 0u : __ldcg(a.sel + l);
    __syncwarp();
    unsigned cum = incl - local;  // keys in bins above the thread's
    if (cum < rank && rank <= incl) {
      int q = kPer - 1;
      for (; q > 0; --q) {
        if (cum + c[q] >= rank) break;
        cum += c[q];
      }
      const unsigned np = pre | (static_cast<unsigned>(lane * kPer + q) << shift);
      if (pass + 1 < kPasses) {
        a.sel[l] = np;
        a.sel[b + l] = rank - cum;
      } else {
        a.kth[(i + 1) * b + l] = float_of(np);
      }
    }
  }
  grid.sync();
}

template <bool VEC, bool SELECT>
__global__ void __launch_bounds__(kThreads, 2) lane_forward_kernel(const FwdArgs a) {
  // [groups * 128] the block's best keys, then (max_active) its histogram
  extern __shared__ unsigned smem[];
  cg::grid_group grid = cg::this_grid();
  const Walk pw = walk_of(a.pieces, a.b);
  const Walk sw = walk_of(a.s, a.b);
  const Walk hw = walk_of(a.hubs, a.b);
  unsigned* sbest = smem;
  unsigned* sh = smem + sw.groups * kLanesPerWarp;
  const int64_t b = a.b;
  const int64_t slab = static_cast<int64_t>(a.s) * b;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t nthreads = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t k = tid; k < static_cast<int64_t>(a.w + 1) * b; k += nthreads) a.best[k] = 0;
  for (int64_t k = tid; k < static_cast<int64_t>(a.hubs) * b; k += nthreads) a.hubkey[k] = 0;
  for (int k = threadIdx.x; k < sw.groups * kLanesPerWarp; k += kThreads) sbest[k] = 0;
  if constexpr (SELECT) {
    for (int64_t k = tid; k < b * kBins; k += nthreads) a.hist[k] = 0;
    for (int k = threadIdx.x; k < kHistWords; k += kThreads) sh[k] = 0;
  }
  grid.sync();
  for (int i = 0; i < a.w; ++i) {
    const float* in = a.seq + i * slab;
    float* out = a.seq + (i + 1) * slab;
    const float* ll_t = a.ll + (a.t0 + i) * a.frame_ll;
    int group = -1;
    FwdLanes ln;
    float bacc[4] = {kNeg, kNeg, kNeg, kNeg};
    for (int64_t u = pw.first; u < pw.units; u += pw.step) {
      const int4 pc = __ldg(a.piece + u / pw.groups);
      const Chunk c = load_chunk(fwd_arcs(a), pc.y, pc.z);
      const int g = static_cast<int>(u % pw.groups);
      if (g != group) {
        if (group >= 0) flush_best(sbest, group, ln, bacc);
        group = g;
        ln = fwd_lanes<SELECT>(a, g, i);
      }
      relax_unit<VEC>(a, in, out, ll_t, pc, c, ln, bacc);
    }
    if (group >= 0) flush_best(sbest, group, ln, bacc);
    __syncthreads();
    for (int k = threadIdx.x; k < sw.groups * kLanesPerWarp; k += kThreads) {
      if (k < a.b && sbest[k] != 0) atomicMax(a.best + (i + 1) * b + k, sbest[k]);
      sbest[k] = 0;
    }
    grid.sync();
    if (a.hubs > 0) {  // the hubs' scores from their pieces' keys
      for (int64_t u = hw.first; u < hw.units; u += hw.step) {
        const int h = static_cast<int>(u / hw.groups);
        const int g = static_cast<int>(u - static_cast<int64_t>(h) * hw.groups);
        const FwdLanes hl = fwd_lanes<SELECT>(a, g, i);
        const int64_t s = __ldg(a.hub + h);
        float x[4] = {0.f, 0.f, 0.f, 0.f};
        if (!hl.all_act) fwd_self<VEC>(in, s, b, hl, x);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (!hl.act[j]) continue;
          unsigned* key = a.hubkey + h * b + hl.l0 + j;
          x[j] = float_of(__ldcg(key));
          *key = 0;
        }
        store4<VEC>(out + s * b + hl.l0, hl.nl, x);
      }
      grid.sync();
    }
    if constexpr (SELECT)
      for (int pass = 0; pass < kPasses; ++pass) select_pass<VEC>(a, grid, sh, i, pass);
  }
  // last phase: seq[W] cut in place, alpha_at_end of the lanes that ended in
  // the window, the cuts of seq[0..W] for the backward
  float* last = a.seq + static_cast<int64_t>(a.w) * slab;
  for (int64_t u = sw.first; u < sw.units; u += sw.step) {
    const int s = static_cast<int>(u / sw.groups);
    const int g = static_cast<int>(u - static_cast<int64_t>(s) * sw.groups);
    const int l0 = first_lane(g);
    const int nl = max(0, min(4, a.b - l0));
    float x[4], c[4];
    bool cut_any = false;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      c[j] = j < nl ? cut_of<SELECT>(a, a.w, l0 + j) : -INFINITY;
      cut_any |= c[j] != -INFINITY;
    }
    load_cg<VEC>(last + s * b + l0, nl, x);
#pragma unroll
    for (int j = 0; j < 4; ++j) x[j] = cut_value(x[j], c[j]);
    if (__any_sync(kFull, cut_any)) store4<VEC>(last + s * b + l0, nl, x);
    if (a.at_end == nullptr) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j >= nl) continue;
      const int e = __ldg(a.nf + l0 + j) - a.t0;  // seq[e] is alpha after frame nf - 1
      if (e < 1 || e > a.w) continue;
      const float y = e == a.w ? x[j]
                               : cut_value(__ldcg(a.seq + e * slab + s * b + l0 + j),
                                           cut_of<SELECT>(a, e, l0 + j));
      a.at_end[s * b + l0 + j] = y;
    }
  }
  for (int64_t k = tid; k < static_cast<int64_t>(a.w + 1) * b; k += nthreads) {
    const int i = static_cast<int>(k / b);
    a.cut[k] = i == a.w ? -INFINITY : cut_of<SELECT>(a, i, static_cast<int>(k - i * b));
  }
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

struct BwdArgs {
  const float* seq;        // [W, S, B] seq[i] with cut[i]: alpha before frame t0 + i
  const float* cut;        // [W, B]
  float* beta;             // [S, B] in: beta above the window; out: beta at t0
  float* beta_tmp;         // [S, B] scratch
  unsigned* hubkey;        // [hubs, B] scratch: the hubs' maxima as ordered keys
  const float* ll;         // [T, P, B]
  const float* final_eff;  // [S, B]
  const float* thresh;     // [B]
  const int4* piece;       // [pieces] (state, lo, hi, hub slot or -1), CSR by source
  const int* hub;          // [hubs] the hubs' states
  const int* out_dst;      // [A]
  const float* out_score;
  const int* out_pdf;
  const int* out_arc;      // [A] the arc id (bit position) of each entry
  const int* nf;           // [B]
  uint8_t* bits;           // [W, B, row] the window's packed survivors
  int64_t frame_ll;        // P * B
  int64_t row;             // bytes a (frame, lane) row: a multiple of 4
  int t0, w, s, b, pieces, hubs;
  float acwt;
};

__device__ __forceinline__ Arcs bwd_arcs(const BwdArgs& a) {
  return Arcs{a.out_dst, a.out_score, a.out_pdf, a.out_arc};
}

// A thread's 4 lanes in one frame of the backward.
struct BwdLanes {
  int l0, nl;
  bool act[4], ends[4];  // t < nf, t + 1 == nf
  float cut[4], th[4];   // alpha_t's cut, total_best - lattice_beam
  bool any_act, all_act, sel;
};

__device__ __forceinline__ BwdLanes bwd_lanes(const BwdArgs& a, int g, int i) {
  BwdLanes ln;
  const int t = a.t0 + i;
  ln.l0 = first_lane(g);
  ln.nl = max(0, min(4, a.b - ln.l0));
  ln.any_act = false;
  ln.all_act = true;
  ln.sel = false;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool in = j < ln.nl;
    const int nf = in ? __ldg(a.nf + ln.l0 + j) : 0;
    ln.act[j] = t < nf;
    ln.ends[j] = in && t + 1 == nf;
    ln.cut[j] = in ? __ldg(a.cut + static_cast<int64_t>(i) * a.b + ln.l0 + j) : 0.f;
    ln.th[j] = in ? __ldg(a.thresh + ln.l0 + j) : 0.f;
    ln.any_act |= ln.act[j];
    ln.all_act &= ln.act[j] || !in;
    ln.sel |= ln.ends[j];
  }
  return ln;
}

// Sets the survivor bits ``mask`` (8 a lane: byte j for lane l0 + j) in
// byte ``byte`` of the thread's 4 lanes' rows, one atomicOr on the 32-bit
// word of each byte that has a bit, and clears the mask.
__device__ __forceinline__ void flush_bits(const BwdArgs& a, uint8_t* bits_t, int l0, int byte,
                                           unsigned& mask) {
  if (!__any_sync(kFull, mask != 0)) return;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const unsigned m = (mask >> (8 * j)) & 0xffu;
    if (m == 0) continue;
    const uintptr_t p =
        reinterpret_cast<uintptr_t>(bits_t + static_cast<int64_t>(l0 + j) * a.row + byte);
    atomicOr(reinterpret_cast<unsigned*>(p & ~static_cast<uintptr_t>(3)), m << ((p & 3) * 8));
  }
  mask = 0;
}

// One (piece, lane group) of frame i: beta of the piece's state (a hub's
// piece: its maximum into the hub's keys), and the survivor bits of its
// arcs.  Called by all 32 threads of a warp.
template <bool VEC>
__device__ __forceinline__ void beta_unit(const BwdArgs& a, const float* in, float* out,
                                          const float* alpha, const float* ll_t,
                                          uint8_t* bits_t, const int4 pc, const Chunk& c,
                                          const BwdLanes& ln) {
  const int64_t b = a.b;
  float self[4] = {0.f, 0.f, 0.f, 0.f};
  if (pc.w < 0 && !ln.all_act) load_cg<VEC>(in + pc.x * b + ln.l0, ln.nl, self);
  if (!__any_sync(kFull, ln.any_act)) {
    if (pc.w < 0) store4<VEC>(out + pc.x * b + ln.l0, ln.nl, self);
    return;
  }
  float al[4];
  load_ro<VEC>(alpha + pc.x * b + ln.l0, ln.nl, al);
#pragma unroll
  for (int j = 0; j < 4; ++j) al[j] = cut_value(al[j], ln.cut[j]);
  float v[4] = {kNeg, kNeg, kNeg, kNeg};
  int byte = -1;      // the survivor byte the thread's mask is for (warp-uniform)
  unsigned mask = 0;  // its bits for the thread's 4 lanes, lane l0 + j in byte j
  walk_arcs<VEC>(
      bwd_arcs(a), pc.y, pc.z, c, ln.l0, ln.nl, ll_t, b, a.acwt,
      [&](int dst, float (&x)[4]) {  // beta_eff: final_eff in the lanes that end at t + 1
        load_cg<VEC>(in + dst * b + ln.l0, ln.nl, x);
        if (ln.sel) {
          float f[4];
          load_ro<VEC>(a.final_eff + dst * b + ln.l0, ln.nl, f);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (ln.ends[j]) x[j] = f[j];
        }
      },
      [&](const float (&x)[4], const float (&am)[4], float w, int arc) {
        if (arc >> 3 != byte) {
          flush_bits(a, bits_t, ln.l0, byte, mask);
          byte = arc >> 3;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float tail = __fadd_rn(__fadd_rn(am[j], w), x[j]);
          v[j] = fmaxf(v[j], tail);
          const bool keep = ln.act[j] && __fadd_rn(al[j], tail) >= ln.th[j];
          mask |= static_cast<unsigned>(keep) << (8 * j + 7 - (arc & 7));
        }
      });
  flush_bits(a, bits_t, ln.l0, byte, mask);
  if (pc.w >= 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (ln.act[j]) atomicMax(a.hubkey + pc.w * b + ln.l0 + j, key_of(v[j]));
    return;
  }
  float res[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) res[j] = ln.act[j] ? v[j] : self[j];
  store4<VEC>(out + pc.x * b + ln.l0, ln.nl, res);
}

// Zero n bytes from p over the whole grid: 16-byte stores between byte edges.
__device__ __forceinline__ void zero_bytes(uint8_t* p, int64_t n, int64_t tid, int64_t nthreads) {
  const int64_t edge = static_cast<int64_t>((16 - reinterpret_cast<uintptr_t>(p) % 16) % 16);
  const int64_t head = edge < n ? edge : n;
  const int64_t nv = (n - head) / 16;
  uint4* q = reinterpret_cast<uint4*>(p + head);
  for (int64_t k = tid; k < nv; k += nthreads) q[k] = make_uint4(0u, 0u, 0u, 0u);
  for (int64_t k = tid; k < head; k += nthreads) p[k] = 0;
  for (int64_t k = head + nv * 16 + tid; k < n; k += nthreads) p[k] = 0;
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads, 2) lane_backward_kernel(const BwdArgs a) {
  cg::grid_group grid = cg::this_grid();
  const Walk pw = walk_of(a.pieces, a.b);
  const Walk hw = walk_of(a.hubs, a.b);
  const int64_t b = a.b;
  const int64_t slab = static_cast<int64_t>(a.s) * b;
  const int64_t frame_bits = b * a.row;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t nthreads = static_cast<int64_t>(gridDim.x) * kThreads;
  zero_bytes(a.bits + (a.w - 1) * frame_bits, frame_bits, tid, nthreads);
  for (int64_t k = tid; k < static_cast<int64_t>(a.hubs) * b; k += nthreads) a.hubkey[k] = 0;
  grid.sync();
  for (int k = 0; k < a.w; ++k) {
    const int i = a.w - 1 - k;  // frames from the last
    const float* in = (k & 1) ? a.beta_tmp : a.beta;
    float* out = (k & 1) ? a.beta : a.beta_tmp;
    if (i > 0) zero_bytes(a.bits + (i - 1) * frame_bits, frame_bits, tid, nthreads);
    const float* alpha = a.seq + i * slab;
    const float* ll_t = a.ll + (a.t0 + i) * a.frame_ll;
    uint8_t* bits_t = a.bits + i * frame_bits;
    int group = -1;
    BwdLanes ln;
    for (int64_t u = pw.first; u < pw.units; u += pw.step) {
      const int4 pc = __ldg(a.piece + u / pw.groups);
      const Chunk c = load_chunk(bwd_arcs(a), pc.y, pc.z);
      const int g = static_cast<int>(u % pw.groups);
      if (g != group) {
        group = g;
        ln = bwd_lanes(a, g, i);
      }
      beta_unit<VEC>(a, in, out, alpha, ll_t, bits_t, pc, c, ln);
    }
    grid.sync();
    if (a.hubs > 0) {  // the hubs' beta from their pieces' keys
      for (int64_t u = hw.first; u < hw.units; u += hw.step) {
        const int h = static_cast<int>(u / hw.groups);
        const int g = static_cast<int>(u - static_cast<int64_t>(h) * hw.groups);
        const BwdLanes hl = bwd_lanes(a, g, i);
        const int64_t s = __ldg(a.hub + h);
        float x[4] = {0.f, 0.f, 0.f, 0.f};
        if (!hl.all_act) load_cg<VEC>(in + s * b + hl.l0, hl.nl, x);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (!hl.act[j]) continue;
          unsigned* key = a.hubkey + h * b + hl.l0 + j;
          x[j] = float_of(__ldcg(key));
          *key = 0;
        }
        store4<VEC>(out + s * b + hl.l0, hl.nl, x);
      }
      grid.sync();
    }
  }
  if (a.w & 1) {  // the last frame wrote beta_tmp
    for (int64_t k = tid; k < slab; k += nthreads) a.beta[k] = __ldcg(a.beta_tmp + k);
  }
}

// The blocks of a cooperative launch: those that fit on the card at once, no
// more than the units need.
cudaError_t coop_grid(const void* kernel, int64_t units, size_t smem, int* grid) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && smem > 48 * 1024)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  int64_t g = (units + kWarps - 1) / kWarps;
  const int64_t resident = static_cast<int64_t>(per_sm) * sms;
  if (g > resident) g = resident;
  if (g < 1) return cudaErrorCooperativeLaunchTooLarge;
  *grid = static_cast<int>(g);
  return cudaSuccess;
}

bool aligned(const void* p, uintptr_t n) { return (reinterpret_cast<uintptr_t>(p) % n) == 0; }

}  // namespace

// Frames t0 .. t0 + w - 1 of the forward in one cooperative launch.
// seq [W+1, S, B]: seq[0] holds alpha before frame t0 (pruned); the launch
// fills seq[1..W] (seq[i] unpruned with its cut in cut[i]; seq[W] pruned,
// cut -inf).  cut [W+1, B]; at_end [S, B] updated in place, or null; scratch
// u32 [B (2 W + 4 + 256 + hubs)]; ll [T, P, B] (frame t at ll + t P B);
// piece int4 [pieces] (state, lo, hi, hub slot or -1) over the CSR by
// destination (in_src, in_score, in_pdf); hub [hubs] the hubs' states.
extern "C" int vbt_lattice_lane_forward(float* seq, float* cut, float* at_end, unsigned* scratch,
                                        const float* ll, int t_total, int p, const int* piece,
                                        int pieces, const int* hub, int hubs,
                                        const int* in_src, const float* in_score,
                                        const int* in_pdf, const int* nf, int t0, int w,
                                        float acwt, float beam, int max_active, int b, int s,
                                        cudaStream_t stream) {
  if (w < 0 || t0 < 0 || t0 + w > t_total || b < 0 || s < 0 || pieces < s || hubs < 0 ||
      !aligned(piece, 16))
    return cudaErrorInvalidValue;
  if (b == 0 || s == 0 || w == 0) return 0;
  const int64_t wb = static_cast<int64_t>(w + 1) * b;
  unsigned* hist = scratch + 2 * wb;
  unsigned* sel = hist + static_cast<int64_t>(kBins) * b;
  FwdArgs a{seq, cut, at_end, scratch, reinterpret_cast<float*>(scratch + wb), hist, sel,
            sel + 2 * static_cast<int64_t>(b), ll, reinterpret_cast<const int4*>(piece), hub,
            in_src, in_score, in_pdf, nf, static_cast<int64_t>(p) * b, t0, w, s, b, max_active,
            pieces, hubs, acwt, beam};
  const bool vec = b % 4 == 0 && aligned(seq, 16) && aligned(ll, 16) && aligned(at_end, 16);
  const bool select = max_active > 0 && max_active < s;
  const int groups = (b + kLanesPerWarp - 1) / kLanesPerWarp;
  const size_t smem = (static_cast<size_t>(groups) * kLanesPerWarp + (select ? kHistWords : 0)) *
                      sizeof(unsigned);
  const void* k = vec ? (select ? reinterpret_cast<const void*>(lane_forward_kernel<true, true>)
                                : reinterpret_cast<const void*>(lane_forward_kernel<true, false>))
                      : (select ? reinterpret_cast<const void*>(lane_forward_kernel<false, true>)
                                : reinterpret_cast<const void*>(lane_forward_kernel<false, false>));
  int grid = 0;
  const cudaError_t err = coop_grid(k, static_cast<int64_t>(pieces) * groups, smem, &grid);
  if (err != cudaSuccess) return err;
  // a block's 16-bit histogram counters count at most its states of a group
  const int64_t per_block = (s + static_cast<int64_t>(grid) * kWarps - 1) /
                            (static_cast<int64_t>(grid) * kWarps) * kWarps;
  if (select && per_block > kMaxBlockCount) return cudaErrorInvalidValue;
  void* argv[] = {&a};
  return cudaLaunchCooperativeKernel(k, dim3(grid), dim3(kThreads), argv, smem, stream);
}

// Frames t0 + w - 1 .. t0 of the backward in one cooperative launch.  seq
// [W, S, B] and cut [W, B]: alpha before frame t0 + i is seq[i] cut at
// cut[i]; beta [S, B] in/out (beta above the window in, beta at t0 out),
// beta_tmp [S, B] scratch; scratch u32 [hubs B]; final_eff [S, B]; thresh
// [B]; piece int4 [pieces] and hub [hubs] over the CSR by source (out_dst,
// out_score, out_pdf, out_arc); bits [W, B, row] uint8, row >= ceil(A / 8) a
// multiple of 4, zeroed and filled with the window's packed survivors
// (np.packbits order).
extern "C" int vbt_lattice_lane_backward(const float* seq, const float* cut, float* beta,
                                         float* beta_tmp, unsigned* scratch, const float* ll,
                                         int t_total, int p, const float* final_eff,
                                         const float* thresh, const int* piece, int pieces,
                                         const int* hub, int hubs, const int* out_dst,
                                         const float* out_score, const int* out_pdf,
                                         const int* out_arc, const int* nf, int t0, int w,
                                         float acwt, int b, int s, int a_arcs, uint8_t* bits,
                                         long long row, cudaStream_t stream) {
  if (w < 0 || t0 < 0 || t0 + w > t_total || b < 0 || s < 0 || pieces < s || hubs < 0 ||
      !aligned(piece, 16) || row % 4 != 0 || row < (static_cast<long long>(a_arcs) + 7) / 8 ||
      !aligned(bits, 4))
    return cudaErrorInvalidValue;
  if (b == 0 || s == 0 || w == 0) return 0;
  BwdArgs a{seq, cut, beta, beta_tmp, scratch, ll, final_eff, thresh,
            reinterpret_cast<const int4*>(piece), hub, out_dst, out_score, out_pdf, out_arc, nf,
            bits, static_cast<int64_t>(p) * b, row, t0, w, s, b, pieces, hubs, acwt};
  const bool vec = b % 4 == 0 && aligned(seq, 16) && aligned(ll, 16) && aligned(beta, 16) &&
                   aligned(beta_tmp, 16) && aligned(final_eff, 16);
  const int groups = (b + kLanesPerWarp - 1) / kLanesPerWarp;
  const void* k = vec ? reinterpret_cast<const void*>(lane_backward_kernel<true>)
                      : reinterpret_cast<const void*>(lane_backward_kernel<false>);
  int grid = 0;
  const cudaError_t err = coop_grid(k, static_cast<int64_t>(pieces) * groups, 0, &grid);
  if (err != cudaSuccess) return err;
  void* argv[] = {&a};
  return cudaLaunchCooperativeKernel(k, dim3(grid), dim3(kThreads), argv, 0, stream);
}
