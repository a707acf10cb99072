// K4: banded Viterbi alignment over training graphs for Hopper (sm_90a).
//
// Replaces the XLA scans voicebridge_tpu/ops/align_band.py
// (viterbi_forward_banded and backtrace_banded_device).  States of every
// utterance's training graph are renumbered by BFS so that each arc's
// displacement dst - src is one of K band offsets, and all arcs entering a
// state share the state's pdf.  Per utterance b, frame t and state s:
//
//   cand_k    = alpha[s - off_k] + W[b, s, k]        (NEG_INF out of range)
//   bps[t,b,s] = first k with the largest cand_k
//   alpha'[s] = max_k cand_k + fl(ll[b, t, pdf[b, s]] * acwt)   if t < nf[b]
//
// and alpha_end[b] is alpha after the utterance's last frame (alpha0 when it
// has none).  The backtrace takes the end state as the first argmax of
// alpha_end + final and walks s <- s - off[bps[t, b, s]], resolving each
// band slot to the original arc id; an empty slot on the path clears ok.
//
// What bounds it on the H100: the chain of T dependent frames, each a few
// adds and compares per state and one barrier, and the emissions.  Each
// frame gathers one loglik per state from its utterance's [P] row; the
// training graphs draw their pdfs at random, so a frame of 384 states
// touches about 196 of the row's 250 sectors of 32 bytes, and the loglik
// block (614 MB at 192 x 400 x 2000) does not fit in L2: about 480 MB of
// sectors at full width, 0.15 ms.  A gather issued when its frame begins
// puts a round trip to HBM (about 1 us) into every frame of the chain.
// Design: ONE launch for the whole sub-batch, one CTA per utterance looping
// over all T frames with alpha double-buffered in shared memory and one
// __syncthreads per frame.  The emissions of frames t+1 .. t+kDepth-1 are
// in flight while frame t runs, in a ring of kDepth frames in shared memory
// filled by cp.async (one commit group a frame): each thread copies its
// states' logliks and waits for its copies of the next frame before the
// frame's barrier.  (Copying each frame's whole row instead, coalesced, and
// copying in pdf order, so that a warp's copies fall in fewer lines of the
// row, timed slower and the same on the card.)  With K <= 8 and S <= 512 (one state per thread) the kernel is
// compiled for the exact K, with the state's K band weights and the offsets
// in registers: the frame's work is then a few instructions a state;
// otherwise W lives in shared memory when it fits, else it is read through
// L2.  The backpointers are written as one coalesced row of S bytes a
// frame.  The adds and the multiply use __fadd_rn / __fmul_rn (no FMA
// contraction), in the JAX package's order (shift + W, max, + emission), so
// equal inputs give bit-equal scores and equal slot choices as the plain
// version.
//
// The backtrace is a chain too: frame t's band slot is read at the state
// frame t + 1 left.  Read from global memory, as one lane a warp did, every
// frame costs two dependent round trips (the slot, then arc_of to decide
// whether the state moves): 0.125 ms of device time at 192 x 400 frames
// and S = 384, about 0.31 us a frame, on an NVIDIA H100 80GB HBM3 at 700 W.
// Design (align_backtrace_kernel): a CTA per utterance stages its rows of
// backpointers in shared memory, a chunk ahead of the walk, and the walk
// moves by the slot's offset alone, so a frame is one shared-memory load
// and a shift; arc_of is resolved by the other warps beside the walk, and
// an empty slot on the path sends the walk back to global memory from that
// frame, exactly as the plain version holds the state there.  Measured on
// the same card (tools/time_training_kernels.py): 0.030 ms of device time,
// one utterance alone 0.027 ms (about 67 ns a frame), the staged rows' bytes
// bounding it at 0.009 ms.  The walker does no copying: the next chunk's
// copies are issued by the other warps after the chunk's barrier (issued
// before it, they held the walk back, the more so when the walker had no
// share of them).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr float kNeg = -1.0e30f;
constexpr int kMaxThreads = 512;
constexpr size_t kSmemWLimit = 96 * 1024;  // two CTAs per SM at most this
// The backtrace: threads a CTA (warp 0 walks, the others resolve arc ids),
// bytes of backpointer rows a chunk stages (two chunks resident), and the
// most shared memory it asks for.
constexpr int kBtThreads = 128;
constexpr int kBtChunkBytes = 32 * 1024;
constexpr size_t kBtSmemLimit = 226 * 1024;  // beside the static arrays
// Frames of emissions in the ring: the frame being read and 3 in flight (8
// and 16 timed faster with one CTA an SM, slower at full width's 192).
constexpr int kDepth = 4;

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

// alpha[src], NEG_INF outside [0, s)
__device__ __forceinline__ float shifted(const float* alpha, int src, int s) {
  return static_cast<unsigned>(src) < static_cast<unsigned>(s) ? alpha[src] : kNeg;
}

// Where the band weights W live.
enum WMode { kWRegisters, kWShared, kWGlobal };

// kK > 0 (with kWRegisters): one state per thread, exactly kK band slots, W
// and the offsets in registers.  kK == 0: any S (states strided over the
// threads) and K, W in shared memory or read through L2.  Shared memory:
// alpha twice, the emission ring [kDepth][s], the pdfs, the offsets, then W
// [s][k] when kW == kWShared.
template <int kK, WMode kW>
__global__ void __launch_bounds__(kMaxThreads)
align_forward_kernel(const float* __restrict__ W, const int* __restrict__ pdf,
                     const float* __restrict__ alpha0, const float* __restrict__ ll,
                     const int* __restrict__ num_frames, const int* __restrict__ offsets,
                     float acwt, int b_total, int s, int k, int t_total, int p,
                     float* __restrict__ alpha_end, uint8_t* __restrict__ bps) {
  extern __shared__ float smem[];
  float* a_cur = smem;
  float* a_nxt = smem + s;
  float* ring = smem + 2 * s;                                   // [kDepth][s]
  int* pdf_s = reinterpret_cast<int*>(ring + kDepth * s);      // [s]
  int* off_s = pdf_s + s;                                       // [k]
  float* w_s = reinterpret_cast<float*>(off_s + k);             // [s][k]
  const int b = blockIdx.x;
  const int64_t row = static_cast<int64_t>(b) * s;
  const float* w_b = W + row * k;
  const int nf = num_frames[b];
  const int n_ll = min(nf, t_total);  // frames whose emissions are read
  for (int i = threadIdx.x; i < s; i += blockDim.x) {
    const float a0 = alpha0[row + i];
    a_cur[i] = a0;
    pdf_s[i] = pdf[row + i];
    alpha_end[row + i] = nf == 0 ? a0 : kNeg;
  }
  for (int i = threadIdx.x; i < k; i += blockDim.x) off_s[i] = offsets[i];
  if (kW == kWShared)
    for (int i = threadIdx.x; i < s * k; i += blockDim.x) w_s[i] = w_b[i];
  const float* w_src = kW == kWShared ? w_s : w_b;
  const float* ll_b = ll + static_cast<int64_t>(b) * t_total * p;
  constexpr int kR = kK > 0 ? kK : 1;  // registers of the one-state-per-thread form
  const int st0 = threadIdx.x;
  const bool live0 = st0 < s;
  float w_r[kR];
  int off_r[kR];
  if (kK > 0) {
#pragma unroll
    for (int kk = 0; kk < kR; ++kk) {
      w_r[kk] = live0 ? w_b[static_cast<int64_t>(st0) * k + kk] : kNeg;
      off_r[kk] = offsets[kk];
    }
  }
  __syncthreads();
  const int pdf0 = live0 ? pdf_s[st0] : 0;

  // frame tf's emissions of this thread's states into its ring slot
  auto prefetch = [&](int tf) {
    if (tf < n_ll) {
      const float* ll_t = ll_b + static_cast<int64_t>(tf) * p;
      float* slot = ring + (tf % kDepth) * s;
      if (kK > 0) {
        if (live0) copy_async4(slot + st0, ll_t + pdf0);
      } else {
        for (int st = threadIdx.x; st < s; st += blockDim.x)
          copy_async4(slot + st, ll_t + pdf_s[st]);
      }
    }
    copy_commit();
  };
  for (int tf = 0; tf < kDepth - 1; ++tf) prefetch(tf);
  copy_wait_next();  // this thread's copies of frame 0 have landed
  __syncthreads();

  uint8_t* bp_t = bps + static_cast<int64_t>(b) * s;
  const int64_t bp_step = static_cast<int64_t>(b_total) * s;
  for (int t = 0; t < t_total; ++t, bp_t += bp_step) {
    prefetch(t + kDepth - 1);  // into the slot frame t - 1 used
    const float* e_t = ring + (t % kDepth) * s;
    const bool active = t < nf;
    if (kK > 0) {
      if (live0) {
        float best = __fadd_rn(shifted(a_cur, st0 - off_r[0], s), w_r[0]);
        int slot = 0;
#pragma unroll
        for (int kk = 1; kk < kR; ++kk) {
          const float c = __fadd_rn(shifted(a_cur, st0 - off_r[kk], s), w_r[kk]);
          if (c > best) {
            best = c;
            slot = kk;
          }
        }
        bp_t[st0] = static_cast<uint8_t>(slot);
        const float v = active ? __fadd_rn(best, __fmul_rn(e_t[st0], acwt)) : a_cur[st0];
        a_nxt[st0] = v;
        if (t + 1 == nf) alpha_end[row + st0] = v;
      }
    } else {
      for (int st = threadIdx.x; st < s; st += blockDim.x) {
        const float* w_st = w_src + static_cast<int64_t>(st) * k;
        float best = __fadd_rn(shifted(a_cur, st - off_s[0], s), w_st[0]);
        int slot = 0;
        for (int kk = 1; kk < k; ++kk) {
          const float c = __fadd_rn(shifted(a_cur, st - off_s[kk], s), w_st[kk]);
          if (c > best) {
            best = c;
            slot = kk;
          }
        }
        bp_t[st] = static_cast<uint8_t>(slot);
        const float v = active ? __fadd_rn(best, __fmul_rn(e_t[st], acwt)) : a_cur[st];
        a_nxt[st] = v;
        if (t + 1 == nf) alpha_end[row + st] = v;
      }
    }
    copy_wait_next();  // this thread's copies of frame t + 1 have landed
    __syncthreads();
    float* tmp = a_cur;
    a_cur = a_nxt;
    a_nxt = tmp;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The backtrace: one CTA of kBtThreads per utterance.  The end state is a
// block argmax (first maximal index).  The utterance's backpointer rows are
// staged in shared memory by cp.async in chunks of frames, two buffers:
// warps 1.. copy the next chunk while warp 0's lane 0 walks the current
// one, per frame slot = rows[t][st], path[t] = (st, slot), st -=
// offsets[slot] (the offsets a byte each in one register when K <= 8).
// The walk moves by the offset whatever the arc, so arc_of is off the
// chain: warps 1.. also resolve the previous chunk's path to arc ids, and
// keep the highest frame whose slot is empty (the first failure of the
// walk).  The plain version holds the state at that frame, so from there
// lane 0 replays the walk exactly, reading global memory (a slow serial
// path; a failure is rare).  Past a failure the offset walk is wrong and
// may leave [0, s): the state is clamped only to keep its reads in bounds
// until the replay.  A row is copied in the 16-byte aligned pieces that
// cover it, into a slot of `stride` bytes at the same offset modulo 16 (the
// bytes of the neighbouring rows around it are never read); a piece that
// would reach outside the table, at its first or last byte, is copied a
// byte at a time.  kStaged false (rows too wide to stage two): lane 0 walks
// through global memory as the replay does.
template <bool kStaged>
__global__ void __launch_bounds__(kBtThreads)
align_backtrace_kernel(const float* __restrict__ alpha_end,
                       const float* __restrict__ final_score,
                       const uint8_t* __restrict__ bps, const int* __restrict__ num_frames,
                       const int* __restrict__ offsets, const int* __restrict__ arc_of,
                       int b_total, int s, int k, int t_total, int f_chunk,
                       int* __restrict__ arcs, int* __restrict__ end_state,
                       uint8_t* __restrict__ ok_out, float* __restrict__ score_out) {
  extern __shared__ __align__(16) unsigned char bt_smem[];
  __shared__ float red_v[kBtThreads / 32];
  __shared__ int red_i[kBtThreads / 32];
  __shared__ unsigned long long fail_key;  // (t + 1) << 32 | state of the first failure
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int64_t row = static_cast<int64_t>(b) * s;
  const int stride = (s + 15) / 16 * 16 + 16;  // a staged row's slot
  const size_t buf_bytes = kStaged ? static_cast<size_t>(f_chunk) * stride : 0;
  uint8_t* buf0 = bt_smem;
  int* path0 = reinterpret_cast<int*>(bt_smem + 2 * buf_bytes);  // [2][f_chunk]
  int* off_s = path0 + 2 * f_chunk;                               // [k]

  float best = -__int_as_float(0x7f800000);  // -inf
  int arg = s;
  for (int i = tid; i < s; i += kBtThreads) {
    const float v = __fadd_rn(alpha_end[row + i], final_score[row + i]);
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
  if (tid == 0) fail_key = 0ull;
  for (int i = tid; i < k; i += kBtThreads) off_s[i] = offsets[i];
  const int nf = num_frames[b];
  const int n_act = max(0, min(nf, t_total));  // frames the walk steps through
  for (int t = n_act + tid; t < t_total; t += kBtThreads)
    arcs[static_cast<int64_t>(t) * b_total + b] = -1;
  __syncthreads();
  best = red_v[0];
  arg = red_i[0];
  for (int w = 1; w < kBtThreads / 32; ++w)
    if (red_v[w] > best || (red_v[w] == best && red_i[w] < arg)) {
      best = red_v[w];
      arg = red_i[w];
    }
  const int64_t bp_step = static_cast<int64_t>(b_total) * s;
  const uint8_t* bp_b = bps + row;  // frame t's row at bp_b + t * bp_step

  if constexpr (kStaged) {
    const int n_chunks = (n_act + f_chunk - 1) / f_chunk;
    // chunk c: frames [max(0, n_act - (c + 1) f_chunk), n_act - c f_chunk)
    const uint8_t* tbl_end = bps + static_cast<int64_t>(t_total) * bp_step;
    // warps 1..: chunk c's rows (warp 0 only walks)
    auto copy_chunk = [&](int c) {
      if (c < n_chunks) {
        const int hi = n_act - c * f_chunk;
        const int lo = max(0, hi - f_chunk);
        uint8_t* dst = buf0 + (c & 1) * buf_bytes;
        for (int f = warp - 1; f < hi - lo; f += kBtThreads / 32 - 1) {
          const uint8_t* src = bp_b + static_cast<int64_t>(lo + f) * bp_step;
          const uint8_t* first = src - (reinterpret_cast<uintptr_t>(src) & 15);
          uint8_t* d = dst + static_cast<size_t>(f) * stride;
          for (int x = lane; 16 * x < src + s - first; x += 32) {
            const uint8_t* a = first + 16 * x;
            if (a >= bps && a + 16 <= tbl_end) {
              const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(d + 16 * x));
              asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa), "l"(a)
                           : "memory");
            } else {
              for (int y = 0; y < 16; ++y)
                if (a + y >= bps && a + y < tbl_end) d[16 * x + y] = a[y];
            }
          }
        }
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    };
    // warps 1..: the arc ids of chunk c's path, and its failures
    auto resolve = [&](int c) {
      const int hi = n_act - c * f_chunk;
      const int lo = max(0, hi - f_chunk);
      const int* path = path0 + (c & 1) * f_chunk;
      for (int f = tid - 32; f < hi - lo; f += kBtThreads - 32) {
        const int pst = path[f];
        const int st = pst >> 8;
        const int a = __ldg(arc_of + (row + st) * k + (pst & 255));
        arcs[static_cast<int64_t>(lo + f) * b_total + b] = a;
        if (a < 0)
          atomicMax(&fail_key, (static_cast<unsigned long long>(lo + f + 1) << 32) |
                                   static_cast<unsigned>(st));
      }
    };
    if (warp > 0) copy_chunk(0);
    // K <= 8 offsets that fit in a byte live in one register: a step of the
    // walk is then one shared-memory load and a shift, not two loads
    bool packed = k <= 8;
    unsigned long long off_bytes = 0ull;
    for (int i = 0; i < k && packed; ++i) {
      packed = off_s[i] >= -128 && off_s[i] <= 127;
      off_bytes |= static_cast<unsigned long long>(off_s[i] & 0xff) << (8 * i);
    }
    int st = arg;
    for (int c = 0; c < n_chunks; ++c) {
      asm volatile("cp.async.wait_all;\n" ::: "memory");  // this thread's copies of chunk c
      __syncthreads();
      if (warp == 0) {
        if (lane == 0) {
          const int hi = n_act - c * f_chunk;
          const int lo = max(0, hi - f_chunk);
          const uint8_t* rows = buf0 + (c & 1) * buf_bytes;
          int* path = path0 + (c & 1) * f_chunk;
          // frame lo + f's row starts at f * stride + (its address mod 16);
          // both step down a frame at a time, off the walk's chain
          const int step16 = static_cast<int>(bp_step & 15);
          int at = (hi - lo - 1) * stride +
                   static_cast<int>(reinterpret_cast<uintptr_t>(bp_b + (hi - 1) * bp_step) & 15);
          int head = at & 15;
          auto walk = [&](auto offset_of) {
            for (int f = hi - lo - 1; f >= 0; --f) {
              const int slot = rows[at + st];
              path[f] = (st << 8) | slot;
              st -= offset_of(slot);
              st = static_cast<unsigned>(st) < static_cast<unsigned>(s) ? st : 0;
              const int prev = (head - step16) & 15;
              at += prev - head - stride;
              head = prev;
            }
          };
          if (packed)
            walk([&](int slot) { return static_cast<int8_t>(off_bytes >> (8 * slot)); });
          else
            walk([&](int slot) { return off_s[slot]; });
        }
      } else {
        copy_chunk(c + 1);  // into the buffer chunk c - 1 used, while chunk c is walked
        if (c > 0) resolve(c - 1);
      }
      __syncthreads();
    }
    if (n_chunks > 0 && warp > 0) resolve(n_chunks - 1);
    __syncthreads();
  } else if (tid == 0) {
    fail_key = (static_cast<unsigned long long>(n_act) << 32) | static_cast<unsigned>(arg);
  }

  if (tid != 0) return;
  bool ok = best > 0.5f * kNeg;
  const unsigned long long key = fail_key;
  if (key != 0ull) {
    // the exact walk from the first failure (unstaged: from the top)
    int st = static_cast<int>(key & 0xffffffffu);
    for (int t = static_cast<int>(key >> 32) - 1; t >= 0; --t) {
      const int slot = bp_b[t * bp_step + st];
      const int a = __ldg(arc_of + (row + st) * k + slot);
      if (a >= 0)
        st -= off_s[slot];
      else
        ok = false;
      arcs[static_cast<int64_t>(t) * b_total + b] = a;
    }
  }
  score_out[b] = best;
  end_state[b] = arg;
  ok_out[b] = ok ? 1 : 0;
}

struct ForwardArgs {
  const float* W;
  const int* pdf;
  const float* alpha0;
  const float* ll;
  const int* num_frames;
  const int* offsets;
  float acwt;
  int b, s, k, t, p;
  float* alpha_end;
  uint8_t* bps;
};

template <int kK, WMode kW>
cudaError_t launch_forward(const ForwardArgs& a, size_t smem, int threads, cudaStream_t st) {
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(align_forward_kernel<kK, kW>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  align_forward_kernel<kK, kW><<<a.b, threads, smem, st>>>(
      a.W, a.pdf, a.alpha0, a.ll, a.num_frames, a.offsets, a.acwt, a.b, a.s, a.k, a.t, a.p,
      a.alpha_end, a.bps);
  return cudaGetLastError();
}

template <bool kStaged>
cudaError_t launch_backtrace(const float* alpha_end, const float* final_score,
                             const uint8_t* bps, const int* num_frames, const int* offsets,
                             const int* arc_of, int b, int s, int k, int t, int f_chunk,
                             int* arcs, int* end_state, uint8_t* ok, float* score, size_t smem,
                             cudaStream_t st) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(align_backtrace_kernel<kStaged>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  align_backtrace_kernel<kStaged><<<b, kBtThreads, smem, st>>>(
      alpha_end, final_score, bps, num_frames, offsets, arc_of, b, s, k, t, f_chunk, arcs,
      end_state, ok, score);
  return cudaGetLastError();
}

}  // namespace

extern "C" int vbt_align_forward(const float* W, const int* pdf, const float* alpha0,
                                 const float* ll, const int* num_frames, const int* offsets,
                                 float acwt, int b, int s, int k, int t, int p,
                                 float* alpha_end, uint8_t* bps, void* stream) {
  if (b == 0 || s == 0) return 0;
  if (k < 1 || k > 255) return cudaErrorInvalidValue;
  const ForwardArgs a{W, pdf, alpha0, ll, num_frames, offsets, acwt, b, s, k, t, p,
                      alpha_end, bps};
  const int threads = s >= kMaxThreads ? kMaxThreads : ((s + 31) / 32) * 32;
  // alpha twice, the emission ring, pdfs, offsets; then W when it is shared
  const size_t base = sizeof(float) * ((2 + kDepth + 1) * static_cast<size_t>(s) + k);
  const size_t with_w = base + sizeof(float) * static_cast<size_t>(s) * k;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s <= kMaxThreads) {
    switch (k) {
      case 1: return launch_forward<1, kWRegisters>(a, base, threads, st);
      case 2: return launch_forward<2, kWRegisters>(a, base, threads, st);
      case 3: return launch_forward<3, kWRegisters>(a, base, threads, st);
      case 4: return launch_forward<4, kWRegisters>(a, base, threads, st);
      case 5: return launch_forward<5, kWRegisters>(a, base, threads, st);
      case 6: return launch_forward<6, kWRegisters>(a, base, threads, st);
      case 7: return launch_forward<7, kWRegisters>(a, base, threads, st);
      case 8: return launch_forward<8, kWRegisters>(a, base, threads, st);
      default: break;
    }
  }
  if (with_w <= kSmemWLimit) return launch_forward<0, kWShared>(a, with_w, threads, st);
  return launch_forward<0, kWGlobal>(a, base, threads, st);
}

extern "C" int vbt_align_backtrace(const float* alpha_end, const float* final_score,
                                   const uint8_t* bps, const int* num_frames,
                                   const int* offsets, const int* arc_of, int b, int s,
                                   int k, int t, int* arcs, int* end_state, uint8_t* ok,
                                   float* score, void* stream) {
  if (b == 0 || s == 0) return 0;
  if (k < 1 || k > 255 || t < 0) return cudaErrorInvalidValue;
  // frames a chunk stages: kBtChunkBytes of row slots, at least one
  const int stride = (s + 15) / 16 * 16 + 16;
  const int f_chunk = std::max(1, std::min(std::max(t, 1), kBtChunkBytes / stride));
  const size_t smem = static_cast<size_t>(f_chunk) * (2 * stride + 2 * sizeof(int)) +
                      sizeof(int) * k;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (smem > kBtSmemLimit)  // rows too wide to stage: the walk reads global memory
    return launch_backtrace<false>(alpha_end, final_score, bps, num_frames, offsets, arc_of, b,
                                   s, k, t, f_chunk, arcs, end_state, ok, score,
                                   sizeof(int) * (2 * f_chunk + k), st);
  return launch_backtrace<true>(alpha_end, final_score, bps, num_frames, offsets, arc_of, b, s,
                                k, t, f_chunk, arcs, end_state, ok, score, smem, st);
}
