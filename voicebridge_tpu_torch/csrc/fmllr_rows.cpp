// Native fMLLR row update: the sweeps of transforms/fmllr.py's
// estimate_fmllr_batch (Kaldi's FmllrInnerUpdate, fmllr-diag-gmm.cc) for all
// speakers in one call.
//
// Built with g++ at first use by transforms/fmllr.py
// (_build.build_host_library).  The numpy solve spends its time in the ~15
// array calls a row makes (inverse and determinant of A, the cofactor row,
// the quadratic), 800 rows an estimate.  Here a row costs O(D^2): A's
// inverse and determinant are taken by LU once a sweep and carried through
// the sweep's row changes by Sherman-Morrison (A + e_i d^T), so the cofactor
// row det(A) * inv(A)^T[i] is read, not recomputed.
//
// Per speaker s (W = [A | b], rows w_i, D + 1 columns):
//   c_i   = [det(A) * column i of inv(A); 0]
//   gc    = Ginv_i c_i,  c1 = c_i . gc,  c2 = c_i . Ginv_i k_i
//   w_i  <- Ginv_i k_i + step * gc,  step = (-c2 + sqrt(c2^2 + 4 beta c1)) / (2 c1)
// skipped where c1 <= 0 or the speaker is below min_count.  The objective
// beta log|det A| - 0.5 sum_i w_i G_i w_i^T + sum_i w_i . k_i (-inf for
// det A <= 0) is taken after each sweep; the sweeps stop once no speaker's
// moved by 1e-6 of its magnitude (at least 1), as the numpy solve stops.

#include <cmath>
#include <cstdint>
#include <limits>
#include <vector>

namespace {

// LU with partial pivoting of the n x n row-major `a` (in place): the
// determinant through `det` and, when `inv` is given, the inverse; returns
// false for a singular matrix.
bool lu_inverse(int n, std::vector<double>& a, std::vector<double>* inv, double& det) {
  std::vector<int> piv(n);
  double sign = 1.0;
  for (int c = 0; c < n; ++c) {
    int p = c;
    double best = std::fabs(a[c * n + c]);
    for (int r = c + 1; r < n; ++r) {
      double v = std::fabs(a[r * n + c]);
      if (v > best) { best = v; p = r; }
    }
    piv[c] = p;
    if (best == 0.0) return false;
    if (p != c) {
      for (int j = 0; j < n; ++j) std::swap(a[c * n + j], a[p * n + j]);
      sign = -sign;
    }
    double inv_d = 1.0 / a[c * n + c];
    for (int r = c + 1; r < n; ++r) {
      double f = a[r * n + c] * inv_d;
      a[r * n + c] = f;
      if (f != 0.0)
        for (int j = c + 1; j < n; ++j) a[r * n + j] -= f * a[c * n + j];
    }
  }
  det = sign;
  for (int c = 0; c < n; ++c) det *= a[c * n + c];
  if (inv == nullptr) return true;
  // inverse: solve L U X = P I for all columns at once, row by row of X
  // (each step a whole-row update, no reduction chains)
  std::vector<double>& x = *inv;
  for (int r = 0; r < n; ++r)
    for (int e = 0; e < n; ++e) x[r * n + e] = (r == e) ? 1.0 : 0.0;
  for (int c = 0; c < n; ++c)
    if (piv[c] != c)
      for (int e = 0; e < n; ++e) std::swap(x[c * n + e], x[piv[c] * n + e]);
  for (int r = 0; r < n; ++r)
    for (int j = 0; j < r; ++j) {
      double f = a[r * n + j];
      if (f != 0.0)
        for (int e = 0; e < n; ++e) x[r * n + e] -= f * x[j * n + e];
    }
  for (int r = n - 1; r >= 0; --r) {
    for (int j = r + 1; j < n; ++j) {
      double f = a[r * n + j];
      if (f != 0.0)
        for (int e = 0; e < n; ++e) x[r * n + e] -= f * x[j * n + e];
    }
    double inv_d = 1.0 / a[r * n + r];
    for (int e = 0; e < n; ++e) x[r * n + e] *= inv_d;
  }
  return true;
}

// The objective of one speaker's W [D, D+1].
double objective(int d, double beta, const double* w, const double* k, const double* g) {
  const int e1 = d + 1;
  std::vector<double> a(d * d);
  for (int i = 0; i < d; ++i)
    for (int j = 0; j < d; ++j) a[i * d + j] = w[i * e1 + j];
  double det = 0.0;
  double logdet = -std::numeric_limits<double>::infinity();
  if (lu_inverse(d, a, nullptr, det) && det > 0.0) {
    logdet = 0.0;  // log|det| from U's diagonal, as slogdet sums it
    for (int c = 0; c < d; ++c) logdet += std::log(std::fabs(a[c * d + c]));
  }
  // G_i symmetric: G_i w_i as a sum of its rows, scaled
  double quad = 0.0;
  std::vector<double> gw(e1);
  for (int i = 0; i < d; ++i) {
    const double* wi = w + i * e1;
    const double* gi = g + static_cast<int64_t>(i) * e1 * e1;
    for (int e = 0; e < e1; ++e) gw[e] = 0.0;
    for (int f = 0; f < e1; ++f)
      for (int e = 0; e < e1; ++e) gw[e] += gi[f * e1 + e] * wi[f];
    double lin = 0.0, sq = 0.0;
    for (int e = 0; e < e1; ++e) {
      lin += wi[e] * k[i * e1 + e];
      sq += wi[e] * gw[e];
    }
    quad += lin - 0.5 * sq;
  }
  return beta * logdet + quad;
}

// One sweep over the rows of one speaker's W.
void sweep(int d, double beta, double* w, const double* ginv, const double* gk) {
  const int e1 = d + 1;
  std::vector<double> a(d * d), inv(d * d), u(d), gc(e1), v(d);
  for (int i = 0; i < d; ++i)
    for (int j = 0; j < d; ++j) a[i * d + j] = w[i * e1 + j];
  double det = 0.0;
  if (!lu_inverse(d, a, &inv, det)) return;
  for (int i = 0; i < d; ++i) {
    for (int j = 0; j < d; ++j) u[j] = inv[j * d + i];
    const double* gi = ginv + static_cast<int64_t>(i) * e1 * e1;
    const double* gki = gk + i * e1;
    double c1 = 0.0, c2 = 0.0;
    // Ginv_i symmetric: Ginv_i c_i as a sum of its rows, scaled
    for (int e = 0; e < e1; ++e) gc[e] = 0.0;
    for (int f = 0; f < d; ++f) {
      double cf = det * u[f];
      for (int e = 0; e < e1; ++e) gc[e] += gi[f * e1 + e] * cf;
    }
    for (int e = 0; e < d; ++e) {
      c1 += det * u[e] * gc[e];
      c2 += det * u[e] * gki[e];
    }
    if (!(c1 > 0.0)) continue;
    double disc = std::fmax(c2 * c2 + 4.0 * beta * c1, 0.0);
    double step = (-c2 + std::sqrt(disc)) / std::fmax(2.0 * c1, 1e-20);
    double* wi = w + i * e1;
    // A's row i moves by delta: inv(A) and det(A) follow (Sherman-Morrison)
    double denom = 1.0;
    for (int e = 0; e < d; ++e) v[e] = 0.0;
    for (int j = 0; j < d; ++j) {
      double delta = gki[j] + step * gc[j] - wi[j];
      for (int e = 0; e < d; ++e) v[e] += delta * inv[j * d + e];
    }
    denom += v[i];
    for (int e = 0; e < e1; ++e) wi[e] = gki[e] + step * gc[e];
    for (int r = 0; r < d; ++r) {
      double f = u[r] / denom;
      for (int e = 0; e < d; ++e) inv[r * d + e] -= f * v[e];
    }
    det *= denom;
  }
}

}  // namespace

extern "C" {

// w: [S, D, D+1] row-major, in: the start (identity rows), out: the
// transforms.  ginv: [S, D, D+1, D+1] the regularised inverses of G_i;
// gk: [S, D, D+1] Ginv_i k_i; k, g the statistics; active: [S] 0/1.
// objf: [2, S] out, the objective at the start and at the end (0 for an
// inactive speaker).  Returns the number of sweeps made.
int vb_fmllr_rows(int32_t S, int32_t D, int32_t num_iters, const double* beta,
                  const uint8_t* active, const double* k, const double* g,
                  const double* ginv, const double* gk, double* w, double* objf) {
  const int64_t e1 = D + 1;
  const int64_t w_sz = D * e1, g_sz = D * e1 * e1;
  std::vector<double> prev(S), cur(S);
  for (int s = 0; s < S; ++s)
    prev[s] = active[s] ? objective(D, beta[s], w + s * w_sz, k + s * w_sz, g + s * g_sz) : 0.0;
  for (int s = 0; s < S; ++s) objf[s] = prev[s];
  int it = 0;
  while (it < num_iters) {
    ++it;
    for (int s = 0; s < S; ++s)
      if (active[s]) sweep(D, beta[s], w + s * w_sz, ginv + s * g_sz, gk + s * w_sz);
    bool done = true;
    for (int s = 0; s < S; ++s) {
      cur[s] = active[s] ? objective(D, beta[s], w + s * w_sz, k + s * w_sz, g + s * g_sz)
                         : 0.0;
      double tol = 1e-6 * std::fmax(std::fabs(prev[s]), 1.0);
      if (!(cur[s] - prev[s] < tol)) done = false;
    }
    prev.swap(cur);
    if (done) break;
  }
  for (int s = 0; s < S; ++s) objf[S + s] = prev[s];
  return it;
}

}  // extern "C"
