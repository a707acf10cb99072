// The best-path and N-best backtraces for Hopper (sm_90a), one launch each.
//
// backtrace_best replaces the XLA scan of voicebridge_tpu/ops/decode_core.py
// (backtrace_scan, its lax.scan over a block's frames).  For lane b, from
// end_state[b] at the block's last frame down to its first:
//
//   code      = row_start[s] * D + bps[i, s, b]      (the winner's global slot)
//   codes[i,b] = code, arcs[i,b] = row_arc[code]     (-1 at frames t0+i >= nf[b])
//   s         = row_src[code]                        (only on active frames)
//
// and the state at the block's start.  A pad slot's row_arc is -1, which the
// host reads as "no path", as the plain version does.
//
// backtrace_nbest serves the port's backtrace_nbest_device; it has no TPU
// counterpart: the JAX package's backtrace_nbest (voicebridge_tpu/ops/
// viterbi.py:561) is host numpy over copies of the whole tables.  For lane b
// and candidate c, from the end entry (state, slot) down from frame
// nf[b] - 1:
//
//   a = bp_arc[t, b, s, k]; a < 0: the walk fails and stops;
//   else arcs[t, b, c] = a, k = bp_slot[t, b, s, k], s = arc_src[a]
//
// with -1 at every frame the walk does not step (past the lane's end, at and
// below a failure).  The tables are read through their strides, so K7's
// lane-minor [T, S, B, K] tables serve as the [T, B, S, K] views the caller
// holds.

// What bounds them on the H100: neither bytes nor operations.  A walk moves
// a few bytes a frame (about 2.7 MB for 128 lanes x 1000 frames of the best
// path: 0.8 us at 3.35 TB/s), but its frames form a chain of dependent
// loads: the backpointer at (t, s) is read at a state known only after the
// frame above, and the next state one more read after it (row_src, or
// arc_src).  The latency of that chain is the time.
//
// backtrace_best: a warp per lane, the lanes spread over the SMs (one CTA
// of 8 warps per SM holds the row starts; lanes fill its warps only past
// one a SM), and the warp's threads speculate on the current state's slots
// (see best_walk), so a frame is one round trip instead of two.  Measured
// on an NVIDIA H100 80GB HBM3 at 700 W over a 1000-frame table that K3
// wrote (tools/time_viterbi_kernels.py): one lane alone about 0.23 us a
// frame with the table in L2 and 0.43 us with it cold (the thread-per-lane
// chain: 0.32 and 0.67-0.73); 128 lanes 0.26 and 0.46 ms, against 0.62 and
// 1.03-1.09 when all 128 lanes were threads of one CTA on one SM.
//
// backtrace_nbest: a warp per walk, the walks spread over the SMs (one CTA
// an SM holds the compact row starts), and the warp's threads read the
// current state's in-arcs beside its backpointer (see the kernel), so a
// frame is one round trip where the thread-per-walk chain was two.  That
// round trip is long: the backpointer's rows lie 38 MB apart from frame to
// frame over the 38 GB tables of the full-width N-best decode.  Measured on
// an NVIDIA H100 80GB HBM3 at 700 W over K7's tables of 1000 frames x 32
// lanes x 4 slots, 16 walks a lane (tools/time_viterbi_kernels.py --cases
// nbest): all walks 0.34-0.35 ms with the tables in L2 and 0.60-0.68 with
// them cold, against 0.36-0.39 and 0.70-0.82 for the thread per walk; one
// walk alone 0.32-0.34 and 0.56-0.64, as the thread per walk's (whose
// second load, arc_src, hits the cache).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr unsigned kFull = 0xffffffffu;
// backtrace_best: threads a CTA (all copy the row starts; the first
// `lanes` warps walk a lane each) and the most shared memory it asks for
constexpr int kBestThreads = 256;
constexpr size_t kBestSmemLimit = 226 * 1024;
// backtrace_nbest: the most threads a CTA (32 walking warps), the fewest
// (all copy the row starts), states per 32-bit base of the compact row
// starts, and the most shared memory a CTA asks for
constexpr int kNbestMaxThreads = 1024;
constexpr int kNbestCopyThreads = 256;
constexpr int kGroup = 64;
constexpr size_t kNbestSmemLimit = 226 * 1024;

// backtrace_best: one warp per lane.  Per frame i, from the state s known
// to every thread of the warp:
//   rs, n   = the first slot of s's rows and their slot count
//   code    = bps[i, s]                              (one address, all threads)
//   cand_j  = row_src[rs + j] for j < n              (coalesced, beside the code)
//   s       = cand_code                              (a shuffle)
// so row_src no longer waits on the code: a frame is one round trip, the
// code's, where the plain chain is two.  Every thread issues both loads
// (threads past the state's slots repeat its last one) and the rare state
// of more than 32 slots is a warp vote: no divergent branch stands between
// the two loads, which would make them wait on each other.  The row starts
// come from shared memory, as row_start[x] - x in 16 bits (nondecreasing,
// at most R - S), when the table fits and R - S < 65536; else from global
// memory, one more round trip a frame.  A code of 32 or more (a state of more than 32 slots) reads
// row_src[g] after the code.  Thread j keeps the global code of the frame i
// with i % 32 == j; after each group of 32 frames (at i % 32 == 0) it
// stores the group's codes, reads their arc ids, and stores the arcs read
// at the group before (off the chain: the store waits on a load 32 frames
// old).
template <typename BP, bool kSmem>
__device__ __forceinline__ int best_walk(const BP* __restrict__ bps,
                                         const int* __restrict__ row_start,
                                         const uint16_t* __restrict__ rs16,
                                         const int* __restrict__ row_src,
                                         const int* __restrict__ row_arc, int n_act, int s1,
                                         int b, int d, int lane, int j, int s,
                                         int* __restrict__ codes, int* __restrict__ arcs) {
  int my_g = 0, arc_old = 0, old_i = -1;
  for (int i = n_act - 1; i >= 0; --i) {
    int rs, n_cand;
    if constexpr (kSmem) {
      const int lo = rs16[s];
      rs = s + lo;
      n_cand = (1 + rs16[s + 1] - lo) * d;
    } else {
      rs = __ldg(row_start + s);
      n_cand = (__ldg(row_start + s + 1) - rs) * d;
    }
    const int64_t first = static_cast<int64_t>(rs) * d;
    const int64_t row = static_cast<int64_t>(i) * s1;
    const int code = static_cast<int>(__ldg(bps + (row + s) * b + lane));
    const int cand = __ldg(row_src + first + min(j, n_cand - 1));
    const int g = static_cast<int>(first + code);
    my_g = j == (i & 31) ? g : my_g;
    s = __shfl_sync(kFull, cand, code & 31);
    if (__any_sync(kFull, code >= 32)) s = __ldg(row_src + g);  // a state of > 32 slots
    if ((i & 31) == 0) {  // the group of frames i .. i + 31 is walked
      if (old_i >= 0) arcs[static_cast<int64_t>(old_i) * b + lane] = arc_old;
      old_i = i + j < n_act ? i + j : -1;
      if (old_i >= 0) {
        codes[static_cast<int64_t>(old_i) * b + lane] = my_g;
        arc_old = __ldg(row_arc + my_g);
      }
    }
  }
  if (old_i >= 0) arcs[static_cast<int64_t>(old_i) * b + lane] = arc_old;
  return s;
}

// `lanes` walking warps a CTA; shared memory holds the 16-bit row starts
// when `staged` (the launcher found room for them).
template <typename BP>
__global__ void __launch_bounds__(kBestThreads)
backtrace_best_kernel(const BP* __restrict__ bps, const int* __restrict__ row_start,
                      const int* __restrict__ row_src, const int* __restrict__ row_arc,
                      const int* __restrict__ end_state, const int* __restrict__ num_frames,
                      int t0, int w, int s1, int b, int d, int lanes, bool staged,
                      int* __restrict__ codes, int* __restrict__ arcs,
                      int* __restrict__ state_out) {
  extern __shared__ uint16_t rs16[];  // [s1 + 1]: row_start[x] - x
  const int warp = threadIdx.x / 32;
  const int j = threadIdx.x % 32;
  const int lane = blockIdx.x * lanes + warp;  // the decode lane this warp walks
  const bool smem = staged && __ldg(row_start + s1) - s1 < 65536;
  if (smem) {
    const int n = s1 + 1;
    const int n4 = n / 4;  // row_start is 16-byte aligned (checked by the launcher)
    const int4* rs4 = reinterpret_cast<const int4*>(row_start);
#pragma unroll 4
    for (int x = threadIdx.x; x < n4; x += kBestThreads) {
      const int4 v = __ldg(rs4 + x);
      rs16[4 * x] = static_cast<uint16_t>(v.x - 4 * x);
      rs16[4 * x + 1] = static_cast<uint16_t>(v.y - 4 * x - 1);
      rs16[4 * x + 2] = static_cast<uint16_t>(v.z - 4 * x - 2);
      rs16[4 * x + 3] = static_cast<uint16_t>(v.w - 4 * x - 3);
    }
    for (int x = 4 * n4 + threadIdx.x; x < n; x += kBestThreads)
      rs16[x] = static_cast<uint16_t>(__ldg(row_start + x) - x);
    __syncthreads();
  }
  if (warp >= lanes || lane >= b) return;
  int s = __ldg(end_state + lane);
  const int n_act = max(0, min(__ldg(num_frames + lane) - t0, w));  // active: i < n_act
  for (int i = n_act + j; i < w; i += 32) {
    codes[static_cast<int64_t>(i) * b + lane] = -1;
    arcs[static_cast<int64_t>(i) * b + lane] = -1;
  }
  if (n_act > 0) {
    s = smem ? best_walk<BP, true>(bps, row_start, rs16, row_src, row_arc, n_act, s1, b, d,
                                   lane, j, s, codes, arcs)
             : best_walk<BP, false>(bps, row_start, rs16, row_src, row_arc, n_act, s1, b, d,
                                    lane, j, s, codes, arcs);
  }
  if (j == 0) state_out[lane] = s;
}

template <typename BP>
cudaError_t launch_best(const BP* bps, const int* row_start, const int* row_src,
                        const int* row_arc, const int* end_state, const int* num_frames, int t0,
                        int w, int s1, int b, int d, int* codes, int* arcs, int* state_out,
                        cudaStream_t st) {
  static int sms[64];  // multiprocessors, by device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  const int n_sm = dev < 64 ? sms[dev] : 132;
  // lanes a CTA: one CTA an SM holds the row starts, so spread the lanes
  // over the SMs first
  const int lanes = std::min(kBestThreads / 32, std::max(1, (b + n_sm - 1) / n_sm));
  const size_t smem = (static_cast<size_t>(s1) + 1) * sizeof(uint16_t);
  const bool staged = smem <= kBestSmemLimit && reinterpret_cast<uintptr_t>(row_start) % 16 == 0;
  if (staged && smem > 48 * 1024) {
    err = cudaFuncSetAttribute(backtrace_best_kernel<BP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  backtrace_best_kernel<BP><<<(b + lanes - 1) / lanes, kBestThreads, staged ? smem : 0, st>>>(
      bps, row_start, row_src, row_arc, end_state, num_frames, t0, w, s1, b, d, lanes, staged,
      codes, arcs, state_out);
  return cudaGetLastError();
}

// backtrace_nbest: one warp per walk.  Per frame t, from the state s and
// slot k known to every thread of the warp:
//   rs      = in_start[s]                            (shared memory)
//   a, q    = bp_arc[t, s, k], bp_slot[t, s, k]      (one address, all threads)
//   arc_j   = arc[rs + j], src_j = src[rs + j]       (coalesced, beside a and q)
//   s       = src_j where arc_j == a                 (a ballot and a shuffle)
// The arcs entering s are rows of the plan grouped by destination, so the
// backpointer's arc is one of them and its source arrives with it: a frame
// is one round trip, the backpointer's.  Every slot j < 32 reads whatever
// lies at rs + j (the next rows past s's, the last arc past the end): an
// arc id is unique, and src[p] is arc_src[arc[p]] for every p, so any
// match is exact.  A state of more than 32 in-arcs whose winner lies past
// the first 32, or an arc that no slot read (only hand-made tables hold
// one), reads arc_src[a] after the ballot: a warp-uniform branch after both
// loads, never between them.  The row starts come from shared memory as
// 32-bit bases every kGroup states and 16-bit offsets (the launcher stages
// them when the plan has the compact form and it fits), else from global
// memory, one more round trip a frame.  Thread j keeps the arc of the frame
// t with t % 32 == j and stores the group of 32 frames once it is walked:
// stores stay off the chain, and frames past the lane's end and below a
// failure are written outside the loop.
template <bool kSmem>
__global__ void __launch_bounds__(kNbestMaxThreads)
backtrace_nbest_kernel(const int* __restrict__ bp_arc, const int8_t* __restrict__ bp_slot,
                       int64_t st_t, int64_t st_b, int64_t st_s, int64_t st_k,
                       const int* __restrict__ in_start, const uint16_t* __restrict__ in_off,
                       const int* __restrict__ in_base, const int* __restrict__ arc,
                       const int* __restrict__ src, const int* __restrict__ arc_src, int n_base4,
                       int n_off8, int n_arcs, const int* __restrict__ num_frames,
                       const int* __restrict__ state, const int* __restrict__ slot, int b, int c,
                       int t_total, int walks_per_cta, int* __restrict__ arcs,
                       int* __restrict__ state_out, uint8_t* __restrict__ ok_out) {
  extern __shared__ int4 nbest_smem[];
  const int* base_s = reinterpret_cast<const int*>(nbest_smem);  // [4 * n_base4]
  const uint16_t* off_s = reinterpret_cast<const uint16_t*>(nbest_smem + n_base4);  // [8 * n_off8]
  if constexpr (kSmem) {
    const int4* base4 = reinterpret_cast<const int4*>(in_base);
    const int4* off4 = reinterpret_cast<const int4*>(in_off);
    for (int x = threadIdx.x; x < n_base4; x += blockDim.x) nbest_smem[x] = __ldg(base4 + x);
#pragma unroll 4
    for (int x = threadIdx.x; x < n_off8; x += blockDim.x)
      nbest_smem[n_base4 + x] = __ldg(off4 + x);
    __syncthreads();
  }
  const int warp = threadIdx.x / 32;
  const int j = threadIdx.x % 32;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * walks_per_cta + warp;
  const int64_t bc = static_cast<int64_t>(b) * c;
  if (warp >= walks_per_cta || idx >= bc) return;
  const int lane = static_cast<int>(idx / c);
  const int n_act = max(0, min(__ldg(num_frames + lane), t_total));  // walked: t < n_act
  for (int t = n_act + j; t < t_total; t += 32) arcs[t * bc + idx] = -1;
  const int* lane_arc = bp_arc + lane * st_b;
  const int8_t* lane_slot = bp_slot + lane * st_b;
  const int last = max(n_arcs - 1, 0);
  int s = __ldg(state + idx);
  int k = __ldg(slot + idx);
  int my_a = -1;
  int t = n_act - 1;
  for (; t >= 0; --t) {
    int rs;
    if constexpr (kSmem) {
      rs = base_s[s / kGroup] + off_s[s];
    } else {
      rs = __ldg(in_start + s);
    }
    const int64_t e = t * st_t + s * st_s + k * st_k;
    const int a = __ldg(lane_arc + e);
    const int q = __ldg(lane_slot + e);
    const int p = min(rs + j, last);
    const int cand = n_arcs > 0 ? __ldg(arc + p) : -1;
    const int from = n_arcs > 0 ? __ldg(src + p) : 0;
    const unsigned hit = __ballot_sync(kFull, cand == a);
    int next = __shfl_sync(kFull, from, (__ffs(hit) - 1) & 31);
    // the walk fails here (the same a in every thread).  The test reads q
    // too, which is never negative: a value used only past the exit is a
    // load the compiler issues after the branch, a second round trip a frame
    if ((a | q) < 0) break;
    if (hit == 0) next = __ldg(arc_src + a);  // the winner lies past the slots read
    my_a = j == (t & 31) ? a : my_a;
    s = next;
    k = q;
    if ((t & 31) == 0 && t + j < n_act) arcs[(t + j) * bc + idx] = my_a;
  }
  if (t >= 0) {  // failed at frame t: the walked frames of its group, then -1 down to 0
    const int f = (t & ~31) + j;
    if (f > t && f < n_act) arcs[f * bc + idx] = my_a;
    for (int g = j; g <= t; g += 32) arcs[g * bc + idx] = -1;
  }
  if (j == 0) {
    state_out[idx] = s;
    ok_out[idx] = t < 0 ? 1 : 0;
  }
}

template <bool kSmem>
cudaError_t launch_nbest(const int* bp_arc, const int8_t* bp_slot, int64_t st_t, int64_t st_b,
                         int64_t st_s, int64_t st_k, const int* in_start, const uint16_t* in_off,
                         const int* in_base, const int* arc, const int* src, const int* arc_src,
                         int n_base4, int n_off8, int n_arcs, const int* num_frames,
                         const int* state, const int* slot, int b, int c, int t_total,
                         int walks_per_cta, unsigned grid, int threads, size_t smem, int* arcs,
                         int* state_out, uint8_t* ok_out, cudaStream_t st) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        backtrace_nbest_kernel<kSmem>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  backtrace_nbest_kernel<kSmem><<<grid, threads, smem, st>>>(
      bp_arc, bp_slot, st_t, st_b, st_s, st_k, in_start, in_off, in_base, arc, src, arc_src,
      n_base4, n_off8, n_arcs, num_frames, state, slot, b, c, t_total, walks_per_cta, arcs,
      state_out, ok_out);
  return cudaGetLastError();
}

cudaError_t sm_count(int* n_sm) {
  static int sms[64];  // multiprocessors, by device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  *n_sm = dev < 64 ? sms[dev] : 132;
  return cudaSuccess;
}

}  // namespace

// bp_bytes: 1 = uint8 codes, 2 = int16.  w may be 0 (the state passes through).
extern "C" int vbt_backtrace_best(const void* bps, int bp_bytes, const int* row_start,
                                  const int* row_src, const int* row_arc, const int* end_state,
                                  const int* num_frames, int t0, int w, int s1, int b, int d,
                                  int* codes, int* arcs, int* state_out, void* stream) {
  if (w < 0 || d < 1 || (bp_bytes != 1 && bp_bytes != 2)) return cudaErrorInvalidValue;
  if (b == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bp_bytes == 1)
    return launch_best(static_cast<const uint8_t*>(bps), row_start, row_src, row_arc, end_state,
                       num_frames, t0, w, s1, b, d, codes, arcs, state_out, st);
  return launch_best(static_cast<const int16_t*>(bps), row_start, row_src, row_arc, end_state,
                     num_frames, t0, w, s1, b, d, codes, arcs, state_out, st);
}

// Strides in elements, shared by bp_arc and bp_slot.  The plan's rows
// grouped by destination: in_start [s + 1], arc and src [n_arcs] (original
// arc id and source state, ascending id within a row), arc_src [n_arcs] by
// original id; the compact row starts in_base [4 * n_base4] (in_start of
// every kGroup-th state) and in_off [8 * n_off8] (uint16, in_start[x] -
// in_base[x / kGroup]), or in_off null where the plan has no compact form.
extern "C" int vbt_backtrace_nbest(const int* bp_arc, const int8_t* bp_slot, int64_t st_t,
                                   int64_t st_b, int64_t st_s, int64_t st_k, const int* in_start,
                                   const uint16_t* in_off, const int* in_base, const int* arc,
                                   const int* src, const int* arc_src, int s, int n_arcs,
                                   const int* num_frames, const int* state, const int* slot,
                                   int b, int c, int t_total, int* arcs, int* state_out,
                                   uint8_t* ok_out, void* stream) {
  if (t_total < 0 || c < 0 || s < 1 || n_arcs < 0) return cudaErrorInvalidValue;
  const int64_t walks = static_cast<int64_t>(b) * c;
  if (walks == 0) return 0;
  int n_sm = 0;
  const cudaError_t err = sm_count(&n_sm);
  if (err != cudaSuccess) return err;
  // walks a CTA: one CTA an SM holds the row starts, so spread the walks
  // over the SMs first; at least kNbestCopyThreads threads copy them
  const int64_t per_cta = (walks + n_sm - 1) / n_sm;
  const int walks_per_cta = static_cast<int>(std::min<int64_t>(kNbestMaxThreads / 32, per_cta));
  const int threads = std::max(kNbestCopyThreads, 32 * walks_per_cta);
  const int64_t grid = (walks + walks_per_cta - 1) / walks_per_cta;
  if (grid > 0x7fffffff) return cudaErrorInvalidValue;
  const int n_base4 = ((s + kGroup) / kGroup + 3) / 4;  // ceil(ceil((s + 1) / kGroup) / 4)
  const int n_off8 = (s + 8) / 8;                         // ceil((s + 1) / 8)
  const size_t smem = (static_cast<size_t>(n_base4) + n_off8) * sizeof(int4);
  const bool staged = in_off != nullptr && smem <= kNbestSmemLimit &&
                      reinterpret_cast<uintptr_t>(in_off) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(in_base) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (staged)
    return launch_nbest<true>(bp_arc, bp_slot, st_t, st_b, st_s, st_k, in_start, in_off, in_base,
                              arc, src, arc_src, n_base4, n_off8, n_arcs, num_frames, state,
                              slot, b, c, t_total, walks_per_cta, static_cast<unsigned>(grid),
                              threads, smem, arcs, state_out, ok_out, st);
  return launch_nbest<false>(bp_arc, bp_slot, st_t, st_b, st_s, st_k, in_start, in_off, in_base,
                             arc, src, arc_src, 0, 0, n_arcs, num_frames, state, slot, b, c,
                             t_total, walks_per_cta, static_cast<unsigned>(grid), threads, 0,
                             arcs, state_out, ok_out, st);
}
