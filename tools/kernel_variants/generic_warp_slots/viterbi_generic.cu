// Variant of voicebridge_tpu_torch/csrc/viterbi_generic.cu (same C
// interface), left out: the beam's block max as each warp's shuffle-reduced
// max in a parity-double-buffered row of 16 slots, which every thread reads
// and reduces at the next frame's start, in place of one integer warp
// reduction of order-preserving keys and one shared word set by atomicMax.
// The rest of the file, its notes included, is that source's.  Time it with
// tools/time_training_kernels.py --tree on a copy of the checkout with this
// source in csrc/ (times in PERF.md).

// Generic Viterbi alignment over per-utterance training graphs for Hopper
// (sm_90a).
//
// Replaces the XLA scans voicebridge_tpu/ops/viterbi.py
// (viterbi_forward_batched with _tree_reduce_max and _prune, and
// backtrace_batched_device), used when a set of training graphs does not fit
// the banded form of K4.  Every utterance has its own padded graph
// arc_* [B, A]; per utterance b, frame t < nf[b] and state s, over the arcs j
// entering s:
//
//   c_j        = (alpha[src_j] + score_j) + fl(ll[b, t, pdf_j] * acwt)
//   v[s]       = max(NEG_INF, max_j c_j)
//   bps[t,b,s] = the lowest arc id among the maximal c_j (-1 if v <= NEG_INF/2)
//   alpha'[s]  = v[s] if v[s] >= max_s v[s] - beam else NEG_INF
//
// and alpha_end[b] is alpha after the utterance's last frame (alpha0 when it
// has none); frames past the end write bps -1.  Beside bps the forward writes
// codes [B, T, S] uint8: the rank of the winning arc in its destination's
// row of the CSR below, 0xFF where no arc won.  The backtrace takes the end
// state as the first argmax of alpha_end + final and walks
// s <- src[in_start[s] + code]; a 0xFF on the path clears ok and holds the
// state, as the plain version holds it at a -1.
//
// Ties: the JAX package reduces through a gather tree over the arcs sorted
// stably by destination and takes the first maximal slot at each level,
// which is the lowest arc id among equals.  The caller's plan
// (ops/viterbi.py GenericPlanDev) holds the same grouping as a CSR (in_start;
// in_src, in_score, in_lpdf, in_arc in ascending arc id within a
// destination) and a thread walks a row with a strict >.  A row whose arcs
// are all the same (source, score, pdf), as the dead padding state's are,
// gives every arc the same candidate, so its first arc alone decides it: the
// plan's in_len reads 1 there.
//
// What bounds the forward on the H100: the chain of T dependent frames, as in
// K4, and the emissions.  A frame gathers one loglik per distinct pdf of the
// utterance's graph (about 350 of its [P] row at full width); the loglik
// block (614 MB at 192 x 400 x 2000) does not fit in L2, so a gather issued
// when its frame begins puts a round trip to HBM (about 1 us) into every
// frame of the chain.  Design: ONE launch for the sub-batch, one CTA per
// utterance looping over its frames with alpha double-buffered in shared
// memory and ONE __syncthreads a frame:
//  * the emissions of frames t+1 .. t+kDepth-1 are in flight while frame t
//    runs, in a ring of kDepth rows of the graph's distinct pdfs in shared
//    memory, filled by cp.async (one commit group a frame) from the plan's
//    pdf_list; an arc reads its emission through its index into that list;
//  * with S <= 512 (a state a thread) and every row of at most 8 arcs the
//    frame loop is compiled for 2, 4 or 8 arcs, each thread keeping its
//    state's in-arcs (source, score, local pdf, arc id) in registers;
//    otherwise a thread walks its states' rows, the arcs in shared memory
//    when they fit in 96 KB with the rest, else read through L2;
//  * the beam's threshold of frame t is applied when frame t + 1 reads
//    alpha[src], so no second pass and no second barrier: each warp's max
//    (one integer reduction of order-preserving keys) goes into one
//    shared-memory slot of three by atomicMax, and the next frame reads that
//    one word; the pruned values of the last frame are stored as alpha_end
//    after the loop.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W at 192 x 400 frames, S =
// 385 (tools/time_training_kernels.py): 0.355-0.358 ms of device time, was
// 1.42 for the kernel alone.  One utterance alone takes 0.224 ms, about
// 0.56 us a frame, one a streaming multiprocessor 0.233: the chain is bound
// by the instructions its 13 warps issue a frame (so no slot is predicated
// and the first frame keeps alpha0 by a threshold of -inf), and the 60 SMs
// that hold two of the 192 utterances set the full time.  The gathers are
// issued after the frame's shared-memory loads, which otherwise queue
// behind them; a ring of 2 frames then exposes their latency (0.51 ms), one
// of 8 gains nothing over 4.  Warp maxima in 16 shared slots, shuffled and
// re-reduced by every thread (tools/kernel_variants/generic_warp_slots),
// take 0.381 ms.
// Shared memory beyond 48 KB is taken by opt-in; a graph whose alpha and
// rows do not fit in 227 KB is refused, not run another way.  The adds and
// the multiply use __fadd_rn / __fmul_rn in the JAX order, so equal inputs
// give bit-equal scores and equal backpointers as the plain version.
//
// The backtrace is a chain too: frame t's code is read at the state frame
// t + 1 left.  Walked from global memory, one thread per utterance paid two
// dependent round trips a frame (bps, then arc_src): 0.20 ms of device time
// at 192 x 400 frames.  Design (as K4's backtrace in align_band.cu): a CTA
// per utterance stages its rows of codes (contiguous, [T, S] bytes) in
// shared memory by cp.async, in double-buffered chunks a chunk ahead of the
// walk, with the CSR's in_start and in-arc sources beside them; lane 0 walks
// st <- src[in_start[st] + code], two dependent shared-memory loads a frame,
// and warps 1-3 issue the next chunk's copies and resolve the previous
// chunk's CSR positions to arc ids, writing arcs [T, B].  A 0xFF holds the
// state in the walk itself (the code says the arc is missing, so no replay
// is needed).  Without codes (a row of more than 255 arcs) or when the rows
// do not fit, thread 0 walks bps through global memory.  Measured on the
// same card: 0.025 ms of device time (one utterance alone 0.024), was 0.109
// for the kernel alone.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr float kNeg = -1.0e30f;
constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr size_t kSmemArcLimit = 96 * 1024;  // two CTAs per SM at most this
constexpr size_t kSmemMax = 227 * 1024;
constexpr unsigned kNoArc = 0xFF;
// Frames of emissions in the ring: the frame being read and 3 in flight.
constexpr int kDepth = 4;
// The backtrace: threads a CTA (lane 0 walks, warps 1-3 copy and resolve),
// bytes of code rows a chunk stages (two chunks resident), and the most
// shared memory it asks for.
constexpr int kBtThreads = 128;
constexpr int kBtChunkBytes = 32 * 1024;
constexpr size_t kBtSmemLimit = 200 * 1024;

__device__ __forceinline__ void copy_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// every group but the newest kDepth - 2 has landed
__device__ __forceinline__ void copy_wait_next() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kDepth - 2) : "memory");
}

// A float's bits as an unsigned key of the same order (for the integer warp
// and shared-memory max), and back.
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float key_value(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

struct ForwardArgs {
  const int* in_start;   // [B, S+1]
  const int* in_len;     // [B, S] arcs of a row the forward reads
  const int* in_src;     // [B, A] CSR order
  const float* in_score;  // [B, A]
  const int* in_lpdf;    // [B, A] index into pdf_list[b]
  const int* in_arc;     // [B, A] original arc id
  const int* pdf_list;   // [B, U]
  const int* n_pdf;      // [B]
  const float* alpha0;   // [B, S]
  const float* ll;       // [B, T, P]
  const int* num_frames;  // [B]
  float acwt, beam;
  int b, s, a, u, t, p;
  float* alpha_end;  // [B, S]
  int* bps;          // [T, B, S]
  uint8_t* codes;    // [B, T, S] or null
};

// Where a thread finds its states' in-arcs.
enum ArcMode { kArcRegisters, kArcShared, kArcGlobal };

// kDeg > 0 (kArcRegisters): one state per thread, at most kDeg arcs a row
// in registers.  kDeg == 0: states strided over the threads, rows in shared
// memory or read through L2.  Shared memory: alpha twice, the frames'
// maxima as keys [4] (three in use), the emission ring [kDepth][u], the pdf
// list [u]; then for
// kDeg == 0 the row starts and lengths [s] each, and with kArcShared the
// rows' sources, scores, local pdfs and arc ids [a] each.
template <int kDeg, ArcMode kMode>
__global__ void __launch_bounds__(kMaxThreads) generic_forward_kernel(const ForwardArgs f) {
  extern __shared__ __align__(16) float smem[];
  const int s = f.s, u = f.u, a = f.a;
  float* a_cur = smem;
  float* a_nxt = smem + s;
  float* red = smem + 2 * s;                                  // [2][kMaxWarps]
  float* ring = red + 2 * kMaxWarps;                          // [kDepth][u]
  int* pdf_s = reinterpret_cast<int*>(ring + kDepth * u);    // [u]
  int* start_s = pdf_s + u;                                   // [s]
  int* len_s = start_s + s;                                   // [s]
  int* src_s = len_s + s;                                     // [a]
  float* w_s = reinterpret_cast<float*>(src_s + a);           // [a]
  int* lp_s = reinterpret_cast<int*>(w_s + a);                // [a]
  int* arc_s = lp_s + a;                                      // [a]
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int64_t row = static_cast<int64_t>(b) * s;
  const int64_t arow = static_cast<int64_t>(b) * a;
  const int* start_b = f.in_start + static_cast<int64_t>(b) * (s + 1);
  const int nf = f.num_frames[b];
  const int n_act = max(0, min(nf, f.t));  // frames the chain runs
  const int npdf = f.n_pdf[b];
  for (int i = tid; i < s; i += blockDim.x) a_cur[i] = f.alpha0[row + i];
  for (int i = tid; i < 2 * kMaxWarps; i += blockDim.x) red[i] = kNeg;
  for (int i = tid; i < npdf; i += blockDim.x) pdf_s[i] = f.pdf_list[static_cast<int64_t>(b) * u + i];
  const int pdf_r = tid < npdf ? f.pdf_list[static_cast<int64_t>(b) * u + tid] : 0;
  if (kDeg == 0) {
    for (int i = tid; i < s; i += blockDim.x) {
      start_s[i] = start_b[i];
      len_s[i] = f.in_len[row + i];
    }
  }
  if (kMode == kArcShared) {
    for (int j = tid; j < a; j += blockDim.x) {
      src_s[j] = f.in_src[arow + j];
      w_s[j] = f.in_score[arow + j];
      lp_s[j] = f.in_lpdf[arow + j];
      arc_s[j] = f.in_arc[arow + j];
    }
  }
  // registers of the one-state-per-thread form; a slot past the row holds
  // score -inf, whose candidate (-inf, or NaN) never passes the strict >
  constexpr int kR = kDeg > 0 ? kDeg : 1;
  int src_r[kR], lp_r[kR], arc_r[kR];
  float w_r[kR];
  if (kDeg > 0 && tid < s) {
    const int j0 = start_b[tid];
    const int n_r = f.in_len[row + tid];
#pragma unroll
    for (int kk = 0; kk < kR; ++kk) {
      const bool has = kk < n_r;
      src_r[kk] = has ? f.in_src[arow + j0 + kk] : 0;
      w_r[kk] = has ? f.in_score[arow + j0 + kk] : -__int_as_float(0x7f800000);
      lp_r[kk] = has ? f.in_lpdf[arow + j0 + kk] : 0;
      arc_r[kk] = has ? f.in_arc[arow + j0 + kk] : -1;
    }
  }
  const float* ll_b = f.ll + static_cast<int64_t>(b) * f.t * f.p;

  // frame tf's emissions into its ring slot: each thread copies the pdfs it
  // wrote into pdf_s itself (its first in a register), so no barrier is
  // needed before the first call
  auto prefetch = [&](int tf) {
    if (tf < n_act) {
      const float* ll_t = ll_b + static_cast<int64_t>(tf) * f.p;
      float* slot = ring + (tf % kDepth) * u;
      if (tid < npdf) copy_async4(slot + tid, ll_t + pdf_r);
      for (int i = tid + blockDim.x; i < npdf; i += blockDim.x)
        copy_async4(slot + i, ll_t + pdf_s[i]);
    }
    copy_commit();
  };
  for (int tf = 0; tf < kDepth - 1; ++tf) prefetch(tf);
  copy_wait_next();  // this thread's copies of frame 0 have landed
  __syncthreads();

  int* bp_t = f.bps + row;  // frame t's row at bps + (t * B + b) * S
  const int64_t bp_step = static_cast<int64_t>(f.b) * s;
  uint8_t* code_t = f.codes == nullptr ? nullptr : f.codes + row * f.t;  // + t * S
  const int warp = tid / 32;
  for (int t = 0; t < n_act; ++t, bp_t += bp_step) {
    const float* e_t = ring + (t % kDepth) * u;
    // frame t - 1's beam threshold, applied as alpha is read (-inf keeps
    // alpha0 as it is)
    float thresh = -__int_as_float(0x7f800000);
    if (t > 0) {
      const float* r = red + ((t - 1) & 1) * kMaxWarps;
      float top = r[0];
#pragma unroll
      for (int i = 1; i < kMaxWarps; ++i) top = fmaxf(top, r[i]);
      thresh = __fsub_rn(top, f.beam);
    }
    auto alpha_at = [&](int src) {
      const float v = a_cur[src];
      return v >= thresh ? v : kNeg;
    };
    float lmax = kNeg;
    if (kDeg > 0) {
      if (tid < s) {
        float best = kNeg;
        int win = -1, win_arc = -1;
#pragma unroll
        for (int kk = 0; kk < kR; ++kk) {
          const float c = __fadd_rn(__fadd_rn(alpha_at(src_r[kk]), w_r[kk]),
                                    __fmul_rn(e_t[lp_r[kk]], f.acwt));
          if (c > best) {
            best = c;
            win = kk;
            win_arc = arc_r[kk];
          }
        }
        const bool live = best > 0.5f * kNeg;
        bp_t[tid] = live ? win_arc : -1;
        if (code_t != nullptr) code_t[tid] = static_cast<uint8_t>(live ? win : kNoArc);
        a_nxt[tid] = best;
        lmax = best;
      }
    } else {
      for (int st = tid; st < s; st += blockDim.x) {
        const int j0 = start_s[st];
        const int j1 = j0 + len_s[st];
        float best = kNeg;
        int win = -1;
        for (int j = j0; j < j1; ++j) {
          int src, lp;
          float w;
          if (kMode == kArcShared) {
            src = src_s[j];
            w = w_s[j];
            lp = lp_s[j];
          } else {
            src = f.in_src[arow + j];
            w = f.in_score[arow + j];
            lp = f.in_lpdf[arow + j];
          }
          const float c = __fadd_rn(__fadd_rn(alpha_at(src), w), __fmul_rn(e_t[lp], f.acwt));
          if (c > best) {
            best = c;
            win = j;
          }
        }
        const bool live = best > 0.5f * kNeg;
        bp_t[st] = !live ? -1 : kMode == kArcShared ? arc_s[win] : f.in_arc[arow + win];
        if (code_t != nullptr) code_t[st] = static_cast<uint8_t>(live ? win - j0 : kNoArc);
        a_nxt[st] = best;
        lmax = fmaxf(lmax, best);
      }
    }
    for (int delta = 16; delta > 0; delta /= 2)
      lmax = fmaxf(lmax, __shfl_xor_sync(0xffffffffu, lmax, delta));
    if (tid % 32 == 0) red[(t & 1) * kMaxWarps + warp] = lmax;
    // issued after the frame's shared-memory loads, which would otherwise
    // queue behind the gathers' wavefronts
    prefetch(t + kDepth - 1);  // into the slot frame t - 1 read
    copy_wait_next();  // this thread's copies of frame t + 1 have landed
    __syncthreads();
    float* tmp = a_cur;
    a_cur = a_nxt;
    a_nxt = tmp;
    if (code_t != nullptr) code_t += s;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");

  // alpha_end: alpha0 with no frames; after the last frame its pruned
  // scores; NEG_INF when the utterance runs past the frames given
  float thresh = 0.0f;
  if (n_act > 0) {
    const float* r = red + ((n_act - 1) & 1) * kMaxWarps;
    float top = r[0];
    for (int i = 1; i < kMaxWarps; ++i) top = fmaxf(top, r[i]);
    thresh = __fsub_rn(top, f.beam);
  }
  for (int i = tid; i < s; i += blockDim.x) {
    float v = a_cur[i];
    if (nf == 0)
      v = f.alpha0[row + i];
    else if (nf < 0 || nf > f.t)
      v = kNeg;
    else if (!(v >= thresh))
      v = kNeg;
    f.alpha_end[row + i] = v;
  }
  for (int t = n_act; t < f.t; ++t) {
    int* bp_row = f.bps + (static_cast<int64_t>(t) * f.b + b) * s;
    for (int i = tid; i < s; i += blockDim.x) bp_row[i] = -1;
    if (f.codes != nullptr) {
      uint8_t* c_row = f.codes + (row * f.t + static_cast<int64_t>(t) * s);
      for (int i = tid; i < s; i += blockDim.x) c_row[i] = static_cast<uint8_t>(kNoArc);
    }
  }
}

struct BacktraceArgs {
  const float* alpha_end;    // [B, S]
  const float* final_score;  // [B, S]
  const uint8_t* codes;      // [B, T, S] or null (then bps is walked)
  const int* bps;            // [T, B, S]
  const int* num_frames;     // [B]
  const int* in_start;       // [B, S+1] (with codes)
  const int* in_src;         // [B, A] CSR order (with codes)
  const int* in_arc;         // [B, A] CSR order (with codes)
  const int* arc_src;        // [B, A] arc order (without codes)
  int b, s, a, t, f_chunk;
  int* arcs;        // [T, B]
  uint8_t* ok;      // [B]
  int* end_state;   // [B]
  float* score;     // [B]
};

// The backtrace: one CTA of kBtThreads per utterance.  The end state is a
// block argmax (first maximal index).  kStaged: the utterance's code rows
// are staged in shared memory by cp.async in chunks of f_chunk frames, two
// buffers: warps 1-3 copy the next chunk while lane 0 walks the current one,
// per frame code = rows[f][st], path[f] = in_start[st] + code (-1 at 0xFF),
// st = src[path[f]]; warps 1-3 also resolve the previous chunk's path to
// arc ids.  A chunk's rows are one contiguous run of bytes, copied in the
// 16-byte aligned pieces that cover it into a buffer at the same offset
// modulo 16; a piece that would reach outside the table is copied a byte at
// a time.  !kStaged: thread 0 walks bps and arc_src in global memory.
template <bool kStaged>
__global__ void __launch_bounds__(kBtThreads) generic_backtrace_kernel(const BacktraceArgs g) {
  extern __shared__ __align__(16) unsigned char bt_smem[];
  __shared__ float red_v[kBtThreads / 32];
  __shared__ int red_i[kBtThreads / 32];
  const int s = g.s, a = g.a;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int64_t row = static_cast<int64_t>(b) * s;
  const int64_t arow = static_cast<int64_t>(b) * a;
  // staged layout: two code buffers, the row starts [s + 1], the in-arc
  // sources [a], the path [2][f_chunk]
  const size_t buf_bytes = kStaged ? (static_cast<size_t>(g.f_chunk) * s + 15) / 16 * 16 + 32 : 0;
  uint8_t* buf0 = bt_smem;
  int* start_s = reinterpret_cast<int*>(bt_smem + 2 * buf_bytes);
  int* src_s = start_s + s + 1;
  int* path0 = src_s + a;

  float best = -__int_as_float(0x7f800000);  // -inf
  int arg = s;
  for (int i = tid; i < s; i += kBtThreads) {
    const float v = __fadd_rn(g.alpha_end[row + i], g.final_score[row + i]);
    if (v > best) {
      best = v;
      arg = i;
    }
  }
  for (int delta = 16; delta > 0; delta /= 2) {
    const float ov = __shfl_down_sync(0xffffffffu, best, delta);
    const int oi = __shfl_down_sync(0xffffffffu, arg, delta);
    if (ov > best || (ov == best && oi < arg)) {
      best = ov;
      arg = oi;
    }
  }
  if (lane == 0) {
    red_v[warp] = best;
    red_i[warp] = arg;
  }
  if (kStaged) {
    const int* start_b = g.in_start + static_cast<int64_t>(b) * (s + 1);
    for (int i = tid; i <= s; i += kBtThreads) start_s[i] = start_b[i];
    for (int j = tid; j < a; j += kBtThreads) src_s[j] = g.in_src[arow + j];
  }
  const int nf = g.num_frames[b];
  const int n_act = max(0, min(nf, g.t));  // frames the walk steps through
  for (int t = n_act + tid; t < g.t; t += kBtThreads)
    g.arcs[static_cast<int64_t>(t) * g.b + b] = -1;
  __syncthreads();
  best = red_v[0];
  arg = red_i[0];
  for (int w = 1; w < kBtThreads / 32; ++w)
    if (red_v[w] > best || (red_v[w] == best && red_i[w] < arg)) {
      best = red_v[w];
      arg = red_i[w];
    }
  bool ok = best > 0.5f * kNeg;

  if constexpr (kStaged) {
    const int f_chunk = g.f_chunk;
    const int n_chunks = (n_act + f_chunk - 1) / f_chunk;
    const uint8_t* codes_b = g.codes + row * g.t;  // frame t's row at + t * s
    const uint8_t* tbl_end = g.codes + static_cast<int64_t>(g.b) * g.t * s;
    // chunk c: frames [max(0, n_act - (c + 1) f_chunk), n_act - c f_chunk)
    auto bounds = [&](int c, int& lo, int& hi) {
      hi = n_act - c * f_chunk;
      lo = max(0, hi - f_chunk);
    };
    // warps 1..3: chunk c's rows into buffer c & 1
    auto copy_chunk = [&](int c) {
      if (c < n_chunks) {
        int lo, hi;
        bounds(c, lo, hi);
        const uint8_t* src = codes_b + static_cast<int64_t>(lo) * s;
        const uint8_t* first = src - (reinterpret_cast<uintptr_t>(src) & 15);
        const uint8_t* end = src + static_cast<int64_t>(hi - lo) * s;
        uint8_t* dst = buf0 + (c & 1) * buf_bytes;
        for (int x = tid - 32; first + 16 * x < end; x += kBtThreads - 32) {
          const uint8_t* p = first + 16 * x;
          if (p >= g.codes && p + 16 <= tbl_end) {
            const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(dst + 16 * x));
            asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa), "l"(p)
                         : "memory");
          } else {
            for (int y = 0; y < 16; ++y)
              if (p + y >= g.codes && p + y < tbl_end) dst[16 * x + y] = p[y];
          }
        }
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    };
    // warps 1..3: the arc ids of chunk c's path
    auto resolve = [&](int c) {
      int lo, hi;
      bounds(c, lo, hi);
      const int* path = path0 + (c & 1) * f_chunk;
      for (int f = tid - 32; f < hi - lo; f += kBtThreads - 32) {
        const int j = path[f];
        g.arcs[static_cast<int64_t>(lo + f) * g.b + b] = j >= 0 ? __ldg(g.in_arc + arow + j) : -1;
      }
    };
    if (warp > 0) copy_chunk(0);
    int st = arg;
    for (int c = 0; c < n_chunks; ++c) {
      asm volatile("cp.async.wait_all;\n" ::: "memory");  // this thread's copies of chunk c
      __syncthreads();
      if (tid == 0) {
        int lo, hi;
        bounds(c, lo, hi);
        const uint8_t* src = codes_b + static_cast<int64_t>(lo) * s;
        const uint8_t* rows =
            buf0 + (c & 1) * buf_bytes + (reinterpret_cast<uintptr_t>(src) & 15);
        int* path = path0 + (c & 1) * f_chunk;
        for (int f = hi - lo - 1; f >= 0; --f) {
          const unsigned code = rows[f * s + st];
          const int j = start_s[st] + static_cast<int>(code);
          const bool hit = code != kNoArc;
          path[f] = hit ? j : -1;
          if (hit) st = src_s[j];
          ok = ok && hit;
        }
      } else if (warp > 0) {
        copy_chunk(c + 1);  // into the buffer chunk c - 1 used, while chunk c is walked
        if (c > 0) resolve(c - 1);
      }
      __syncthreads();
    }
    if (n_chunks > 0 && warp > 0) resolve(n_chunks - 1);
  } else if (tid == 0) {
    int st = arg;
    for (int t = n_act - 1; t >= 0; --t) {
      const int arc = g.bps[(static_cast<int64_t>(t) * g.b + b) * s + st];
      if (arc >= 0)
        st = g.arc_src[arow + arc];
      else
        ok = false;
      g.arcs[static_cast<int64_t>(t) * g.b + b] = arc;
    }
  }
  if (tid != 0) return;
  g.score[b] = best;
  g.end_state[b] = arg;
  g.ok[b] = ok ? 1 : 0;
}

template <int kDeg, ArcMode kMode>
cudaError_t launch_forward(const ForwardArgs& f, size_t smem, int threads, cudaStream_t st) {
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(generic_forward_kernel<kDeg, kMode>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  generic_forward_kernel<kDeg, kMode><<<f.b, threads, smem, st>>>(f);
  return cudaGetLastError();
}

template <bool kStaged>
cudaError_t launch_backtrace(const BacktraceArgs& g, size_t smem, cudaStream_t st) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(generic_backtrace_kernel<kStaged>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  generic_backtrace_kernel<kStaged><<<g.b, kBtThreads, smem, st>>>(g);
  return cudaGetLastError();
}

}  // namespace

// max_deg: the largest in_len of the plan (the host knows it); codes may be
// null.
extern "C" int vbt_generic_forward(const int* in_start, const int* in_len, const int* in_src,
                                   const float* in_score, const int* in_lpdf, const int* in_arc,
                                   const int* pdf_list, const int* n_pdf, const float* alpha0,
                                   const float* ll, const int* num_frames, float acwt,
                                   float beam, int b, int s, int a, int u, int t, int p,
                                   int max_deg, float* alpha_end, int* bps, uint8_t* codes,
                                   void* stream) {
  if (b == 0 || s == 0) return 0;
  if (codes != nullptr && max_deg > 255) return cudaErrorInvalidValue;
  const ForwardArgs f{in_start, in_len, in_src, in_score, in_lpdf, in_arc, pdf_list, n_pdf,
                      alpha0, ll, num_frames, acwt, beam, b, s, a, u, t, p, alpha_end, bps,
                      codes};
  const int threads = s >= kMaxThreads ? kMaxThreads : ((s + 31) / 32) * 32;
  // alpha twice, the warps' maxima, the emission ring, the pdf list; then
  // the row starts and lengths; then the rows
  const size_t base =
      sizeof(float) * (2 * static_cast<size_t>(s) + 2 * kMaxWarps + (kDepth + 1) * static_cast<size_t>(u));
  const size_t with_rows = base + 2 * sizeof(int) * static_cast<size_t>(s);
  const size_t with_arcs = with_rows + 16 * static_cast<size_t>(a);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s <= kMaxThreads) {
    if (max_deg <= 2) return launch_forward<2, kArcRegisters>(f, base, threads, st);
    if (max_deg <= 4) return launch_forward<4, kArcRegisters>(f, base, threads, st);
    if (max_deg <= 8) return launch_forward<8, kArcRegisters>(f, base, threads, st);
  }
  if (with_arcs <= kSmemArcLimit) return launch_forward<0, kArcShared>(f, with_arcs, threads, st);
  return launch_forward<0, kArcGlobal>(f, with_rows, threads, st);
}

// codes null: walk bps (in_start, in_src and in_arc may then be null too).
extern "C" int vbt_generic_backtrace(const float* alpha_end, const float* final_score,
                                     const uint8_t* codes, const int* bps, const int* num_frames,
                                     const int* in_start, const int* in_src, const int* in_arc,
                                     const int* arc_src, int b, int s, int a, int t, int* arcs,
                                     uint8_t* ok, int* end_state, float* score, void* stream) {
  if (b == 0 || s == 0) return 0;
  if (t < 0) return cudaErrorInvalidValue;
  // frames a chunk stages: kBtChunkBytes of rows, at least one
  const int f_chunk = std::max(1, std::min(std::max(t, 1), kBtChunkBytes / s));
  BacktraceArgs g{alpha_end, final_score, codes, bps, num_frames, in_start, in_src, in_arc,
                  arc_src, b, s, a, t, f_chunk, arcs, ok, end_state, score};
  const size_t buf_bytes = (static_cast<size_t>(f_chunk) * s + 15) / 16 * 16 + 32;
  const size_t smem = 2 * buf_bytes +
                      sizeof(int) * (static_cast<size_t>(s) + 1 + a + 2 * static_cast<size_t>(f_chunk));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (codes == nullptr || smem > kBtSmemLimit) return launch_backtrace<false>(g, 0, st);
  return launch_backtrace<true>(g, smem, st);
}
