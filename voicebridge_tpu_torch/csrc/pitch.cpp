// Native pitch-tracker Viterbi: O(T*L) lower-envelope recursion.
//
// Built with g++ at first use by ops/pitch.py (_build.build_host_library).
// The pitch recursion (ops/pitch.py viterbi_pitch; reference
// pitch-functions.cc ComputeBacktraces:306-371, Ghahremani et al. 2014 eq. 5)
// is, per frame,
//
//     cost'[i] = local[t][i] + min_j ( cost[j] + c * (j - i)^2 )
//
// — a 1-D squared-distance transform.  The numpy implementation materializes
// the [L, L] candidate matrix per frame (argmin overhead measured 84% of the
// whole pitch chain at L=208); here the Felzenszwalb-Huttenlocher lower
// envelope of parabolas computes the same minimum (and its argmin) in O(L)
// per frame.  Tie-breaking: at exact float ties between parabolas the
// envelope keeps the earlier lag, matching numpy argmin's first-minimum
// convention except on boundary ties of measure zero.

#include <cstddef>
#include <cstdint>
#include <limits>
#include <vector>

using std::size_t;

extern "C" {

// local: [T * L] row-major local costs; track: [T] output lag indices.
// Returns 0 on success, 1 for ifactor <= 0: the parabolas' intersections
// divide by it (the caller runs its numpy recursion then).
int vb_pitch_viterbi(int32_t T, int32_t L, const double* local,
                     double ifactor, int32_t* track) {
  if (T <= 0 || L <= 0) return 0;
  if (!(ifactor > 0.0)) return 1;
  const double kInf = std::numeric_limits<double>::infinity();
  std::vector<double> cost(local, local + L);  // frame 0: local only
  std::vector<double> ncost(L);
  std::vector<int32_t> bp((size_t)T * L);
  std::vector<int32_t> v(L);   // parabola apices in the envelope
  std::vector<double> z(L + 1);  // envelope breakpoints

  for (int32_t t = 1; t < T; ++t) {
    // lower envelope of parabolas j: cost[j] + ifactor * (i - j)^2
    int k = 0;
    v[0] = 0;
    z[0] = -kInf;
    z[1] = kInf;
    for (int32_t j = 1; j < L; ++j) {
      double s;
      for (;;) {
        const int32_t p = v[k];
        // intersection of parabola j with parabola p
        s = ((cost[j] + ifactor * (double)j * j) -
             (cost[p] + ifactor * (double)p * p)) /
            (2.0 * ifactor * (double)(j - p));
        if (s <= z[k] && k > 0) {
          --k;
          continue;
        }
        break;
      }
      if (s <= z[k]) {  // k == 0: parabola j dominates everywhere so far
        v[0] = j;
      } else {
        ++k;
        v[k] = j;
        z[k] = s;
      }
      z[k + 1] = kInf;
    }
    int q = 0;
    const double* loc_t = local + (size_t)t * L;
    int32_t* bp_t = bp.data() + (size_t)t * L;
    for (int32_t i = 0; i < L; ++i) {
      while (z[q + 1] < (double)i) ++q;
      const int32_t j = v[q];
      const double d = (double)i - (double)j;
      ncost[i] = cost[j] + ifactor * d * d + loc_t[i];
      bp_t[i] = j;
    }
    cost.swap(ncost);
  }

  int32_t best = 0;
  for (int32_t i = 1; i < L; ++i)
    if (cost[i] < cost[best]) best = i;
  track[T - 1] = best;
  for (int32_t t = T - 1; t > 0; --t)
    track[t - 1] = bp[(size_t)t * L + track[t]];
  return 0;
}

}  // extern "C"
