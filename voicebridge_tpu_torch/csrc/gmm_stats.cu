// K6: aligned-GMM E-step statistics for Hopper (sm_90a).
//
// Replaces the XLA program voicebridge_tpu/ops/gmm_kernels.py
// (acc_gmm_stats_aligned_twofeats).  For every frame n of nonzero weight
// w_n, aligned to pdf p:
//
//   s_m   = gconst[p,m] + miv[p,m].x_post[n] - 0.5 iv[p,m].x_post[n]^2
//   g_m   = softmax_m(s) * w_n,           ll += logsumexp_m(s) * w_n
//   occ[p,m] += g_m,  mean[p,m,:] += g_m x_acc[n],  var[p,m,:] += g_m x_acc[n]^2
//
// What bounds it on the H100: very little work (2 M (2D) FLOPs per frame
// for the scores and as many for the sums; 80k frames x 5 x 78 is 60
// MFLOP, a bound of 0.01 ms by bytes), so what costs is latency and issue
// slots: launches and the host's gaps between them (a work list built by a
// chain of small torch ops costs about 20 launches), round trips to memory,
// idle threads and conversions.  K6 is two launches and no host
// synchronisation:
//
// 1. gmm_stats_list (cooperative): the work list, a stable counting sort
//    of frame keys by pdf (a frame of weight 0 or with a pdf outside
//    [0, num_pdfs) gets the key num_pdfs and is left out).  Phase A: a CTA
//    per chunk of frames counts its keys in shared memory (integer counts:
//    their order does not change the result) and writes the chunk's row of
//    counts.  Phase B: a thread per key turns its column into prefixes over
//    the chunks.  Phase C: every CTA scans the key totals (frames before
//    each key, blocks before each pdf); the (pdf, block) table follows,
//    blocks of at most fpb frames, and the rows of pdfs without frames are
//    zeroed.  Phase D: a CTA per chunk places its frames: each warp counts
//    its 256 frames, the warps' counts become prefixes, and each warp walks
//    its frames 32 at a time and ranks each among the frames of its key
//    with __match_any_sync, so that the frames of one pdf keep their frame
//    order.  The list equals torch.sort(stable) + block_table.
// 2. gmm_stats_blocks: a warp per (pdf, block).  The pdf's parameters and
//    the block's frames are staged in the warp's shared memory by cp.async
//    (every copy in flight at once); the component scores are spread over
//    the lanes by (frame, component), the posteriors computed a frame per
//    lane and kept as float64; each lane owns the mean and variance slots
//    of a dimension and 4 components and sums g x and (g x) x as float64
//    products and adds (one conversion a frame).  A pdf of one block writes
//    its row; otherwise each block writes its partial and takes an integer
//    ticket, and the pdf's last block sums the partials in block order.
//    The last pdf to finish sums the log-likelihoods.
//
// No float atomics: two runs give the same bits.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kListMaxWarps = 8;  // warps per CTA of the work-list kernel
constexpr int kPieces = 8;        // a warp's part of a chunk: 8 pieces of 32 frames
constexpr int kWarpFrames = 32 * kPieces;
constexpr int kStatMaxWarps = 4;  // work items per CTA of the statistics kernel
constexpr int kTile = 32;         // frames a warp stages at a time: one per lane
constexpr size_t kSmemMax = 227 * 1024;

// 4 bytes global -> shared without a register round trip: the issuing
// thread goes on, and a warp's copies are all in flight at once.
__device__ __forceinline__ void copy_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void copy_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

struct ListArgs {
  const int* pdf;
  const float* weights;
  int n, num_pdfs, nchunks, fpb, nblk;
  int* cnt;    // [nchunks][num_pdfs + 1]: each chunk's key counts, then prefixes
  int* total;  // [num_pdfs + 1] frames per key
  int* order;  // [n]
  int* blk_pdf;
  int* blk_lo;
  int* blk_hi;
  int* pdf_blk_lo;
  int* pdf_blk_hi;
  int* ticket;  // [num_pdfs + 2]: blocks done per pdf; pdfs done; pdfs with frames
  double* out;  // [num_pdfs][width] or null (the list alone)
  int width;
  double* ll;
};

// The keys of this warp's frames of chunk c, a piece of 32 per register
// (-1 past n).
__device__ __forceinline__ void warp_keys(const ListArgs& a, int c, int warp, int lane,
                                          int (&keys)[kPieces]) {
  const int base = (c * static_cast<int>(blockDim.x >> 5) + warp) * kWarpFrames + lane;
#pragma unroll
  for (int q = 0; q < kPieces; ++q) {
    const int i = base + 32 * q;
    int key = -1;
    if (i < a.n) {
      const int p = a.pdf[i];
      key = (a.weights[i] != 0.f && p >= 0 && p < a.num_pdfs) ? p : a.num_pdfs;
    }
    keys[q] = key;
  }
}

// Exclusive scan of one int per thread over the CTA; *total gets the sum.
__device__ int block_exclusive_scan(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  int incl = v;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  int off = 0, tot = 0;
  for (int w = 0; w < nw; ++w) {
    off += w < warp ? warp_sums[w] : 0;
    tot += warp_sums[w];
  }
  __syncthreads();
  *total = tot;
  return off + incl - v;
}

// Shared memory: seg [k1], then one region of k1 ints per warp (phase A:
// region 0 holds the chunk's counts; phase C: region 0 holds blk; phase D:
// each warp's counts, then its running offsets).  A chunk is nw x 256
// frames.
__global__ void __launch_bounds__(32 * kListMaxWarps) gmm_stats_list(ListArgs a) {
  extern __shared__ int sm[];
  __shared__ int warp_sums[kListMaxWarps];
  cg::grid_group grid = cg::this_grid();
  const int k1 = a.num_pdfs + 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int gtid = blockIdx.x * blockDim.x + threadIdx.x, nthreads = gridDim.x * blockDim.x;
  int* seg = sm;
  int* hist = sm + k1;
  int* mine = sm + (1 + warp) * k1;
  int keys[kPieces];

  // A: each chunk's key counts, into row c of cnt
  for (int c = blockIdx.x; c < a.nchunks; c += gridDim.x) {
    warp_keys(a, c, warp, lane, keys);
    for (int k = threadIdx.x; k < k1; k += blockDim.x) hist[k] = 0;
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kPieces; ++q)
      if (keys[q] >= 0) atomicAdd(&hist[keys[q]], 1);
    __syncthreads();
    for (int k = threadIdx.x; k < k1; k += blockDim.x)
      a.cnt[static_cast<int64_t>(c) * k1 + k] = hist[k];
    __syncthreads();
  }
  for (int i = gtid; i < a.num_pdfs + 2; i += nthreads) a.ticket[i] = 0;
  grid.sync();

  // B: per key, the exclusive prefix of its counts over the chunks (rows
  // written by other CTAs: read through L2, 8 loads in flight)
  for (int k = gtid; k < k1; k += nthreads) {
    int run = 0;
    for (int c0 = 0; c0 < a.nchunks; c0 += 8) {
      int v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        v[u] = c0 + u < a.nchunks ? __ldcg(a.cnt + static_cast<int64_t>(c0 + u) * k1 + k) : 0;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (c0 + u < a.nchunks) a.cnt[static_cast<int64_t>(c0 + u) * k1 + k] = run;
        run += v[u];
      }
    }
    a.total[k] = run;
  }
  grid.sync();

  // C: every CTA scans the totals: seg[k] frames before key k, blk[p]
  // blocks before pdf p.  The totals come in through L2, 8 loads in flight
  // a thread.
  int* blk = hist;
  for (int k0 = threadIdx.x; k0 < k1; k0 += 8 * blockDim.x) {
    int v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int k = k0 + u * blockDim.x;
      v[u] = k < k1 ? __ldcg(a.total + k) : 0;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int k = k0 + u * blockDim.x;
      if (k < k1) seg[k] = v[u];
    }
  }
  __syncthreads();
  const int per = (k1 + blockDim.x - 1) / blockDim.x;
  const int k_lo = min(k1, static_cast<int>(threadIdx.x) * per), k_hi = min(k1, k_lo + per);
  int fs = 0, bs = 0, live = 0;
  for (int k = k_lo; k < k_hi; ++k) {
    const int t = seg[k];
    fs += t;
    if (k < a.num_pdfs) {
      bs += (t + a.fpb - 1) / a.fpb;
      live += t > 0;
    }
  }
  int frames_kept, real_blocks, live_pdfs;
  int f_off = block_exclusive_scan(fs, warp_sums, &frames_kept);
  int b_off = block_exclusive_scan(bs, warp_sums, &real_blocks);
  block_exclusive_scan(live, warp_sums, &live_pdfs);
  for (int k = k_lo; k < k_hi; ++k) {
    const int t = seg[k];
    seg[k] = f_off;
    f_off += t;
    if (k < a.num_pdfs) {
      blk[k] = b_off;
      b_off += (t + a.fpb - 1) / a.fpb;
    }
  }
  __syncthreads();
  for (int q = gtid; q < a.num_pdfs; q += nthreads) {
    const int start = seg[q], end = seg[q + 1];
    const int nb = (end - start + a.fpb - 1) / a.fpb;
    const int b0 = blk[q];
    a.pdf_blk_lo[q] = b0;
    a.pdf_blk_hi[q] = b0 + nb;
    for (int j = 0; j < nb; ++j) {
      const int lo = start + j * a.fpb;
      a.blk_pdf[b0 + j] = q;
      a.blk_lo[b0 + j] = lo;
      a.blk_hi[b0 + j] = min(lo + a.fpb, end);
    }
  }
  for (int j = real_blocks + gtid; j < a.nblk; j += nthreads) {  // empty blocks
    a.blk_pdf[j] = a.num_pdfs - 1;
    a.blk_lo[j] = 0;
    a.blk_hi[j] = 0;
  }
  if (a.out != nullptr) {
    for (int q = blockIdx.x; q < a.num_pdfs; q += gridDim.x)  // rows of pdfs without frames
      if (seg[q] == seg[q + 1])
        for (int j = threadIdx.x; j < a.width; j += blockDim.x)
          a.out[static_cast<int64_t>(q) * a.width + j] = 0.0;
    if (gtid == 0) {
      a.ticket[a.num_pdfs + 1] = live_pdfs;
      if (live_pdfs == 0) *a.ll = 0.0;
    }
  }
  __syncthreads();  // blk is dead

  // D: each chunk's frames to their places, in frame order within a key: a
  // frame's place is seg[key] + the key's frames in earlier chunks (phase
  // B's prefix) + in earlier warps of this chunk + in earlier pieces of
  // this warp (running offsets in shared memory) + its rank among the
  // piece's lanes of its key
  for (int c = blockIdx.x; c < a.nchunks; c += gridDim.x) {
    warp_keys(a, c, warp, lane, keys);
    int before[kPieces];
#pragma unroll
    for (int q = 0; q < kPieces; ++q)
      before[q] = keys[q] >= 0 ? __ldcg(a.cnt + static_cast<int64_t>(c) * k1 + keys[q]) : 0;
    for (int k = lane; k < k1; k += 32) mine[k] = 0;
    __syncwarp();
#pragma unroll
    for (int q = 0; q < kPieces; ++q)
      if (keys[q] >= 0) atomicAdd(&mine[keys[q]], 1);
    __syncthreads();
    for (int k = threadIdx.x; k < k1; k += blockDim.x) {  // the warps' counts -> prefixes
      int run = 0;
      for (int w = 0; w < nw; ++w) {
        const int v = sm[(1 + w) * k1 + k];
        sm[(1 + w) * k1 + k] = run;
        run += v;
      }
    }
    __syncthreads();
    const int base = (c * nw + warp) * kWarpFrames + lane;
#pragma unroll
    for (int q = 0; q < kPieces; ++q) {
      const int key = keys[q];
      const unsigned peers = __match_any_sync(kFull, key);
      const int leader = __ffs(peers) - 1;
      int run = 0;
      if (key >= 0 && lane == leader) run = mine[key];
      run = __shfl_sync(kFull, run, leader);
      if (key >= 0) {
        a.order[seg[key] + before[q] + run + __popc(peers & ((1u << lane) - 1u))] =
            base + 32 * q;
        if (lane == leader) mine[key] = run + __popc(peers);
      }
      __syncwarp();
    }
    __syncthreads();  // the regions are reused by the next chunk
  }
}

struct StatArgs {
  const float* x_post;
  const float* x_acc;
  const float* weights;
  const float* w;
  int d, m, num_pdfs, nblk;
  int ldx, lds;    // row strides of the staged frames and scores (odd: no bank conflicts)
  int warp_bytes;  // shared memory of one warp
  bool two;        // x_acc is not x_post: staged apart
  const int* order;
  const int* blk_pdf;
  const int* blk_lo;
  const int* blk_hi;
  const int* pdf_blk_lo;
  const int* pdf_blk_hi;
  int* ticket;
  double* partial;  // [nblk][width]
  double* out;      // [num_pdfs][width]: per component [occ, mean[D], var[D]], then ll
  double* ll;
};

// Shared memory of a warp: acc [slots] f64, gd [kTile][m] f64 (the
// posteriors), ws [slots] f32, fidx [kTile], xp [kTile][ldx] f32, xa
// [kTile][ldx] f32 (two feature arrays only), sc [kTile][lds] f32.
__global__ void __launch_bounds__(32 * kStatMaxWarps) gmm_stats_blocks(StatArgs a) {
  extern __shared__ double dsm[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int item = blockIdx.x * (blockDim.x >> 5) + warp;
  if (item >= a.nblk) return;
  const int lo = a.blk_lo[item], hi = a.blk_hi[item];
  if (lo >= hi) return;  // past the real blocks
  const int d = a.d, m = a.m, kdim = 2 * d + 1, slots = m * kdim, width = slots + 1;
  const int ldx = a.ldx, lds = a.lds;
  double* acc = reinterpret_cast<double*>(reinterpret_cast<char*>(dsm) + warp * a.warp_bytes);
  double* gd = acc + slots;
  float* ws = reinterpret_cast<float*>(gd + kTile * m);
  int* fidx = reinterpret_cast<int*>(ws + slots);
  float* xp = reinterpret_cast<float*>(fidx + kTile);
  float* xa = a.two ? xp + kTile * ldx : xp;
  float* sc = xa + kTile * ldx;
  const int p = a.blk_pdf[item];
  const int b0 = a.pdf_blk_lo[p], nb = a.pdf_blk_hi[p] - b0;
  const float* wp = a.w + static_cast<int64_t>(p) * slots;
  for (int j = lane; j < slots; j += 32) {
    copy_async4(ws + j, wp + j);
    acc[j] = 0.0;
  }
  double ll = 0.0;
  for (int base = lo; base < hi; base += kTile) {
    const int nt = min(kTile, hi - base);
    const int fi = lane < nt ? a.order[base + lane] : 0;
    const float wf = lane < nt ? a.weights[fi] : 0.f;
    __syncwarp();  // the previous tile is consumed
    fidx[lane] = fi;
    __syncwarp();
    // the tile's feature rows, every copy in flight at once
    for (int e = lane, f = lane / d, r = lane % d; e < nt * d; e += 32) {
      const int64_t src = static_cast<int64_t>(fidx[f]) * d + r;
      copy_async4(xp + f * ldx + r, a.x_post + src);
      if (a.two) copy_async4(xa + f * ldx + r, a.x_acc + src);
      for (r += 32; r >= d; r -= d) ++f;
    }
    copy_wait_all();
    __syncwarp();
    // component scores, (frame, component) pairs over the lanes, two at a time
    for (int q0 = lane; q0 < nt * m; q0 += 64) {
      const int q1 = min(q0 + 32, nt * m - 1);
      const int f0 = q0 / m, c0 = q0 - f0 * m, f1 = q1 / m, c1 = q1 - f1 * m;
      const float* x0 = xp + f0 * ldx;
      const float* x1 = xp + f1 * ldx;
      const float* w0 = ws + c0 * kdim;
      const float* w1 = ws + c1 * kdim;
      float v0 = w0[2 * d], v1 = w1[2 * d];
      for (int k = 0; k < d; ++k) {
        const float y0 = x0[k], y1 = x1[k];
        v0 = fmaf(w0[d + k], y0 * y0, fmaf(w0[k], y0, v0));
        v1 = fmaf(w1[d + k], y1 * y1, fmaf(w1[k], y1, v1));
      }
      sc[f0 * lds + c0] = v0;
      if (q0 + 32 < nt * m) sc[f1 * lds + c1] = v1;
    }
    __syncwarp();
    if (lane < nt) {  // this lane's frame: posteriors times the weight
      const float* s = sc + lane * lds;
      float mx = s[0];
      for (int c = 1; c < m; ++c) mx = fmaxf(mx, s[c]);
      float sum = 0.f;
      for (int c = 0; c < m; ++c) sum += expf(s[c] - mx);
      for (int c = 0; c < m; ++c)
        gd[lane * m + c] = static_cast<double>(expf(s[c] - mx) / sum * wf);
      ll += static_cast<double>((mx + logf(sum)) * wf);
    }
    __syncwarp();
    // occ[c] += g; per (dimension, 4 components) unit: mean += g x and
    // var += (g x) x in float64, x converted once a frame
    for (int c = lane; c < m; c += 32) {
      double v = acc[c * kdim];
      for (int f = 0; f < nt; ++f) v += gd[f * m + c];
      acc[c * kdim] = v;
    }
    for (int u = lane; u < d * ((m + 3) / 4); u += 32) {
      const int cb = 4 * (u / d), k = u - (cb / 4) * d;
      int cc[4];
      double mean[4], var[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        cc[j] = min(cb + j, m - 1);  // past m: a copy of the last, not stored
        mean[j] = acc[cc[j] * kdim + 1 + k];
        var[j] = acc[cc[j] * kdim + 1 + d + k];
      }
      for (int f = 0; f < nt; ++f) {
        const double x = xa[f * ldx + k];
        const double* g = gd + f * m;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const double gx = g[cc[j]] * x;
          mean[j] += gx;
          var[j] = fma(gx, x, var[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (cb + j < m) {
          acc[cc[j] * kdim + 1 + k] = mean[j];
          acc[cc[j] * kdim + 1 + d + k] = var[j];
        }
    }
  }
  for (int off = 16; off > 0; off >>= 1) ll += __shfl_down_sync(kFull, ll, off);
  __syncwarp();
  double* row = a.out + static_cast<int64_t>(p) * width;
  if (nb == 1) {
    for (int j = lane; j < slots; j += 32) row[j] = acc[j];
    if (lane == 0) row[slots] = ll;
  } else {
    double* part = a.partial + static_cast<int64_t>(item) * width;
    for (int j = lane; j < slots; j += 32) part[j] = acc[j];
    if (lane == 0) part[slots] = ll;
    __threadfence();
    __syncwarp();
    int ticket = 0;
    if (lane == 0) ticket = atomicAdd(&a.ticket[p], 1);
    if (__shfl_sync(kFull, ticket, 0) != nb - 1) return;
    __threadfence();  // the pdf's last block: every partial has landed
    // each slot's sum in block order; 4 slots x 8 blocks of loads in flight
    for (int j0 = lane; j0 < width; j0 += 128) {
      double sum[4] = {0.0, 0.0, 0.0, 0.0};
      for (int bb = b0; bb < b0 + nb; bb += 8) {
        double v[4][8];
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const int j = j0 + 32 * u, b = bb + q;
            v[u][q] = j < width && b < b0 + nb
                          ? __ldcg(a.partial + static_cast<int64_t>(b) * width + j)
                          : 0.0;
          }
#pragma unroll
        for (int q = 0; q < 8; ++q)
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (bb + q < b0 + nb) sum[u] += v[u][q];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (j0 + 32 * u < width) row[j0 + 32 * u] = sum[u];
    }
  }
  __threadfence();
  __syncwarp();
  int done = 0;
  if (lane == 0) done = atomicAdd(&a.ticket[a.num_pdfs], 1);
  if (__shfl_sync(kFull, done, 0) != a.ticket[a.num_pdfs + 1] - 1) return;
  __threadfence();  // the last pdf: every row has landed
  double tot = 0.0;
#pragma unroll 16
  for (int q = lane; q < a.num_pdfs; q += 32)
    tot += __ldcg(a.out + static_cast<int64_t>(q) * width + slots);
  for (int off = 16; off > 0; off >>= 1) tot += __shfl_down_sync(kFull, tot, off);
  if (lane == 0) *a.ll = tot;
}

// The cooperative launch of the work-list kernel: as many CTAs as fit on
// the card at once, at most one per chunk or per CTA's worth of keys.
cudaError_t launch_list(ListArgs a, cudaStream_t stream) {
  const int k1 = a.num_pdfs + 1;
  int nw = kListMaxWarps;
  while (nw > 1 && sizeof(int) * static_cast<size_t>(nw + 1) * k1 > kSmemMax) nw /= 2;
  const size_t smem = sizeof(int) * static_cast<size_t>(nw + 1) * k1;
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  a.nchunks = (a.n + nw * kWarpFrames - 1) / (nw * kWarpFrames);
  // the CTAs that fit on the card at once, asked once per device and size
  thread_local int cached_dev = -1;
  thread_local size_t cached_smem = 0;
  thread_local int64_t resident = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != cached_dev || smem != cached_smem) {
    if (smem > 48 * 1024)
      err = cudaFuncSetAttribute(gmm_stats_list, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
    int coop = 0, sms = 0, per_sm = 0;
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gmm_stats_list, 32 * nw, smem);
    if (err != cudaSuccess) return err;
    if (!coop) return cudaErrorNotSupported;
    cached_dev = dev;
    cached_smem = smem;
    resident = static_cast<int64_t>(per_sm) * sms;
  }
  const int key_ctas = (k1 + 32 * nw - 1) / (32 * nw);
  int64_t grid = a.nchunks > key_ctas ? a.nchunks : key_ctas;
  if (grid > resident) grid = resident;
  if (grid < 1) return cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&a};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(gmm_stats_list),
                                     dim3(static_cast<unsigned>(grid)), dim3(32 * nw), args, smem,
                                     stream);
}

ListArgs list_args(const int* pdf, const float* weights, int n, int num_pdfs, int fpb,
                   int nblk, int* cnt, int* total, int* order, int* blk_pdf, int* blk_lo,
                   int* blk_hi, int* pdf_blk_lo, int* pdf_blk_hi, int* ticket) {
  ListArgs a;
  a.pdf = pdf;
  a.weights = weights;
  a.n = n;
  a.num_pdfs = num_pdfs;
  a.nchunks = 0;  // set by launch_list
  a.fpb = fpb;
  a.nblk = nblk;
  a.cnt = cnt;
  a.total = total;
  a.order = order;
  a.blk_pdf = blk_pdf;
  a.blk_lo = blk_lo;
  a.blk_hi = blk_hi;
  a.pdf_blk_lo = pdf_blk_lo;
  a.pdf_blk_hi = pdf_blk_hi;
  a.ticket = ticket;
  a.out = nullptr;
  a.width = 0;
  a.ll = nullptr;
  return a;
}

}  // namespace

// The work list alone (launch 1).  cnt holds (num_pdfs + 1) x ceil(n / 256)
// ints (enough for any chunk of the sort), total num_pdfs + 1, ticket
// num_pdfs + 2.
extern "C" int vbt_gmm_stats_list(const int* pdf, const float* weights, int n, int num_pdfs,
                                  int fpb, int nblk, int* cnt, int* total, int* order,
                                  int* blk_pdf, int* blk_lo, int* blk_hi, int* pdf_blk_lo,
                                  int* pdf_blk_hi, int* ticket, void* stream) {
  if (num_pdfs < 1 || fpb < 1) return cudaErrorInvalidValue;
  return launch_list(list_args(pdf, weights, n, num_pdfs, fpb, nblk, cnt, total, order, blk_pdf,
                               blk_lo, blk_hi, pdf_blk_lo, pdf_blk_hi, ticket),
                     static_cast<cudaStream_t>(stream));
}

// The statistics: the work list, then a warp per (pdf, block).  out is
// [num_pdfs][m (2d+1) + 1], ll one double, partial [nblk][m (2d+1) + 1].
extern "C" int vbt_gmm_stats(const float* x_post, const float* x_acc, const float* weights,
                             int d, const float* w, int m, const int* pdf, int n, int num_pdfs,
                             int fpb, int nblk, int* cnt, int* total, int* order, int* blk_pdf,
                             int* blk_lo, int* blk_hi, int* pdf_blk_lo, int* pdf_blk_hi,
                             int* ticket, double* partial, double* out, double* ll,
                             void* stream) {
  if (num_pdfs < 1 || fpb < 1 || d < 1 || m < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int slots = m * (2 * d + 1);
  ListArgs la = list_args(pdf, weights, n, num_pdfs, fpb, nblk, cnt, total, order, blk_pdf,
                          blk_lo, blk_hi, pdf_blk_lo, pdf_blk_hi, ticket);
  la.out = out;
  la.width = slots + 1;
  la.ll = ll;
  cudaError_t err = launch_list(la, st);
  if (err != cudaSuccess) return err;
  StatArgs a;
  a.x_post = x_post;
  a.x_acc = x_acc;
  a.weights = weights;
  a.w = w;
  a.d = d;
  a.m = m;
  a.num_pdfs = num_pdfs;
  a.nblk = nblk;
  a.ldx = d | 1;
  a.lds = m | 1;
  a.two = x_acc != x_post;
  const size_t warp_bytes =
      sizeof(double) * (slots + kTile * m) + sizeof(float) * slots + sizeof(int) * kTile +
      sizeof(float) * kTile * ((a.two ? 2 : 1) * a.ldx + a.lds);
  a.warp_bytes = static_cast<int>((warp_bytes + 7) / 8 * 8);
  a.order = order;
  a.blk_pdf = blk_pdf;
  a.blk_lo = blk_lo;
  a.blk_hi = blk_hi;
  a.pdf_blk_lo = pdf_blk_lo;
  a.pdf_blk_hi = pdf_blk_hi;
  a.ticket = ticket;
  a.partial = partial;
  a.out = out;
  a.ll = ll;
  int warps = kStatMaxWarps;
  while (warps > 1 && static_cast<size_t>(warps) * a.warp_bytes > kSmemMax) --warps;
  const size_t smem = static_cast<size_t>(warps) * a.warp_bytes;
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  thread_local int attr_dev = -1;
  thread_local size_t attr_smem = 48 * 1024;  // what the kernel may take without asking
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != attr_dev) attr_smem = 48 * 1024;
  if (smem > attr_smem) {
    err = cudaFuncSetAttribute(gmm_stats_blocks, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    attr_smem = smem;
  }
  attr_dev = dev;
  if (nblk > 0)
    gmm_stats_blocks<<<(nblk + warps - 1) / warps, 32 * warps, smem, st>>>(a);
  return cudaGetLastError();
}
