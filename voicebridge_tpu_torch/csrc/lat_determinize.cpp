// Native pruned lattice determinization: lat/determinize.py's subset
// construction (determinize_lattice_pruned) step for step, so that it gives
// the same states, arcs, weights and transition-id strings.
//
// Built with g++ at first use by lat/determinize.py
// (_build.build_host_library).  The Python construction spends its time per
// NFA state of a subset (dicts, a heap, tuple concatenation): a subset holds
// every NFA state of the word-free stretch it spans, hundreds on a 10 s
// utterance.  Here the same walk runs over flat arrays.
//
// What the Python code's data structures decide is kept: an insertion-ordered
// map for each subset (a dict), the closure's heap on (rank, NFA state), the
// LIFO queue of det states, words in increasing order, ties kept by the
// element met first (a new cost must be lower by 1e-9), the minimum element
// the first of least (total cost, string), and the det state's key the set
// of (NFA state, round(total / 1e-3) half to even, string).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <functional>
#include <limits>
#include <memory>
#include <queue>
#include <unordered_map>
#include <utility>
#include <vector>

namespace {

using Str = std::vector<int32_t>;

struct Arc {
  int32_t dst;
  int32_t word;  // -1: no word
  double gc, ac;
  int32_t tid;  // -1: no transition id
};

struct Nfa {
  std::vector<std::vector<Arc>> arcs;
  std::vector<int64_t> rank;
  int32_t final_state = -1;

  int32_t add_state(int64_t r) {
    arcs.emplace_back();
    rank.push_back(r);
    return static_cast<int32_t>(arcs.size() - 1);
  }
  // an arc of 0..k words: a chain of single-word arcs, the costs and the
  // transition id on the first
  void add_word_seq(int32_t src, int32_t dst, const int32_t* words, int64_t n, double gc,
                    double ac, int32_t tid, int64_t r) {
    if (n == 0) {
      arcs[src].push_back({dst, -1, gc, ac, tid});
      return;
    }
    int32_t cur = src;
    for (int64_t i = 0; i < n; ++i) {
      int32_t nxt = (i == n - 1) ? dst : add_state(r);
      if (i == 0)
        arcs[cur].push_back({nxt, words[i], gc, ac, tid});
      else
        arcs[cur].push_back({nxt, words[i], 0.0, 0.0, -1});
      cur = nxt;
    }
  }
};

struct Elem {
  int32_t q;
  double gc, ac;
  Str tids;
};

// an insertion-ordered map from NFA state to element (a Python dict)
struct Subset {
  std::vector<Elem> elems;
  std::unordered_map<int32_t, int32_t> pos;

  Elem* get(int32_t q) {
    auto it = pos.find(q);
    return it == pos.end() ? nullptr : &elems[it->second];
  }
  const Elem* get(int32_t q) const {
    auto it = pos.find(q);
    return it == pos.end() ? nullptr : &elems[it->second];
  }
  void put(int32_t q, double gc, double ac, Str&& tids) {
    auto it = pos.find(q);
    if (it == pos.end()) {
      pos.emplace(q, static_cast<int32_t>(elems.size()));
      elems.push_back({q, gc, ac, std::move(tids)});
    } else {
      Elem& e = elems[it->second];
      e.gc = gc;
      e.ac = ac;
      e.tids = std::move(tids);
    }
  }
};

// the strings are the subset's own (kept alive, and in place, by `subsets`)
struct KeyItem {
  int32_t q;
  int64_t r;
  const Str* tids;
  bool operator==(const KeyItem& o) const { return q == o.q && r == o.r && *tids == *o.tids; }
};
using Key = std::vector<KeyItem>;  // sorted by q

struct KeyHash {
  size_t operator()(const Key& k) const {
    uint64_t h = 1469598103934665603ull;
    auto mix = [&h](uint64_t v) { h = (h ^ v) * 1099511628211ull; };
    // a string by its length and last ids: equal keys compare in full
    for (const KeyItem& it : k) {
      mix(static_cast<uint64_t>(it.q));
      mix(static_cast<uint64_t>(it.r));
      const Str& t = *it.tids;
      mix(t.size());
      for (size_t i = t.size() > 4 ? t.size() - 4 : 0; i < t.size(); ++i)
        mix(static_cast<uint32_t>(t[i]));
    }
    return static_cast<size_t>(h);
  }
};

struct Result {
  int32_t num_states = 0;
  std::vector<int32_t> src, dst, word;
  std::vector<double> gc, ac;
  std::vector<int64_t> tid_off{0};
  std::vector<int32_t> tids;
  std::vector<int32_t> fin_state;
  std::vector<double> fin_gc, fin_ac;
  std::vector<int64_t> fin_off{0};
  std::vector<int32_t> fin_tids;
};

class Determinizer {
 public:
  Determinizer(const Nfa& nfa, const std::vector<double>& beta, double lm, double acwt,
               double limit)
      : nfa_(nfa), beta_(beta), lm_(lm), acwt_(acwt), limit_(limit) {}

  double total(double gc, double ac) const { return gc * lm_ + ac * acwt_; }

  // epsilon closure of `in` (consumed), the elements outside the beam dropped
  Subset closure(Subset& in, double base) {
    using Item = std::pair<int64_t, int32_t>;
    std::priority_queue<Item, std::vector<Item>, std::greater<Item>> heap;
    std::unordered_map<int32_t, char> inq;
    for (const Elem& e : in.elems) {
      heap.push({nfa_.rank[e.q], e.q});
      inq[e.q] = 1;
    }
    while (!heap.empty()) {
      int32_t q = heap.top().second;
      heap.pop();
      inq[q] = 0;
      // by index: a put may move the elements (no arc leads back to q)
      const int32_t at = in.pos[q];
      const double gc = in.elems[at].gc, ac = in.elems[at].ac;
      for (const Arc& a : nfa_.arcs[q]) {
        if (a.word != -1) continue;
        double ngc = gc + a.gc, nac = ac + a.ac;
        if (base + total(ngc, nac) + beta_[a.dst] > limit_) continue;
        Elem* old = in.get(a.dst);
        if (old == nullptr || total(ngc, nac) < total(old->gc, old->ac) - 1e-9) {
          const Str& from = in.elems[at].tids;
          Str t;
          t.reserve(from.size() + 1);
          t.assign(from.begin(), from.end());
          if (a.tid >= 0) t.push_back(a.tid);
          in.put(a.dst, ngc, nac, std::move(t));
          char& flag = inq[a.dst];
          if (!flag) {
            heap.push({nfa_.rank[a.dst], a.dst});
            flag = 1;
          }
        }
      }
    }
    Subset out;
    for (Elem& e : in.elems)
      if (base + total(e.gc, e.ac) + beta_[e.q] <= limit_)
        out.put(e.q, e.gc, e.ac, std::move(e.tids));
    return out;
  }

  static int64_t quantized(double t) { return static_cast<int64_t>(std::nearbyint(t / 1e-3)); }

  Key key_of(const Subset& s) const {
    Key k;
    k.reserve(s.elems.size());
    for (const Elem& e : s.elems) k.push_back({e.q, quantized(total(e.gc, e.ac)), &e.tids});
    std::sort(k.begin(), k.end(),
              [](const KeyItem& a, const KeyItem& b) { return a.q < b.q; });
    return k;
  }

  // returns 0, or 1 past max_states
  int run(int64_t max_states, Result& res) {
    std::unordered_map<Key, int32_t, KeyHash> ids;
    std::vector<std::unique_ptr<Subset>> subsets;
    std::vector<double> fwd;
    Subset start;
    start.put(0, 0.0, 0.0, Str());
    subsets.push_back(std::make_unique<Subset>(closure(start, 0.0)));
    fwd.push_back(0.0);
    ids.emplace(key_of(*subsets[0]), 0);
    std::vector<int32_t> queue{0};
    while (!queue.empty()) {
      int32_t sid = queue.back();
      queue.pop_back();
      double f = fwd[sid];
      // word arcs grouped by word, the groups in order of first appearance
      std::vector<int32_t> words;
      std::unordered_map<int32_t, Subset> by_word;
      {
        const Subset& cur = *subsets[sid];
        if (const Elem* e = cur.get(nfa_.final_state)) {
          res.fin_state.push_back(sid);
          res.fin_gc.push_back(e->gc);
          res.fin_ac.push_back(e->ac);
          res.fin_tids.insert(res.fin_tids.end(), e->tids.begin(), e->tids.end());
          res.fin_off.push_back(static_cast<int64_t>(res.fin_tids.size()));
        }
        for (const Elem& e : cur.elems) {
          for (const Arc& a : nfa_.arcs[e.q]) {
            if (a.word == -1) continue;
            double ngc = e.gc + a.gc, nac = e.ac + a.ac;
            if (f + total(ngc, nac) + beta_[a.dst] > limit_) continue;
            auto it = by_word.find(a.word);
            if (it == by_word.end()) {
              words.push_back(a.word);
              it = by_word.emplace(a.word, Subset()).first;
            }
            Subset& tgt = it->second;
            Elem* old = tgt.get(a.dst);
            if (old == nullptr || total(ngc, nac) < total(old->gc, old->ac) - 1e-9) {
              Str t = e.tids;
              if (a.tid >= 0) t.push_back(a.tid);
              tgt.put(a.dst, ngc, nac, std::move(t));
            }
          }
        }
      }
      std::sort(words.begin(), words.end());
      for (int32_t w : words) {
        Subset next = closure(by_word[w], f);
        if (next.elems.empty()) continue;
        // divide out the least (total, string) element's costs and the
        // prefix all strings share
        const Elem* m = &next.elems[0];
        const Str& first = next.elems[0].tids;
        size_t p = first.size();
        for (const Elem& e : next.elems) {
          double te = total(e.gc, e.ac), tm = total(m->gc, m->ac);
          if (te < tm || (te == tm && e.tids < m->tids)) m = &e;
          size_t j = 0, n = std::min(p, e.tids.size());
          while (j < n && e.tids[j] == first[j]) ++j;
          p = j;
        }
        double bg = m->gc, ba = m->ac;
        Str prefix(first.begin(), first.begin() + p);
        auto normed = std::make_unique<Subset>();
        for (Elem& e : next.elems)
          normed->put(e.q, e.gc - bg, e.ac - ba,
                      p == 0 ? std::move(e.tids) : Str(e.tids.begin() + p, e.tids.end()));
        Key key = key_of(*normed);
        auto found = ids.find(key);
        int32_t nid;
        if (found == ids.end()) {
          if (static_cast<int64_t>(subsets.size()) >= max_states) return 1;
          nid = static_cast<int32_t>(subsets.size());
          ids.emplace(std::move(key), nid);
          subsets.push_back(std::move(normed));
          fwd.push_back(f + total(bg, ba));
          queue.push_back(nid);
        } else {
          nid = found->second;
        }
        res.src.push_back(sid);
        res.dst.push_back(nid);
        res.word.push_back(w);
        res.gc.push_back(bg);
        res.ac.push_back(ba);
        res.tids.insert(res.tids.end(), prefix.begin(), prefix.end());
        res.tid_off.push_back(static_cast<int64_t>(res.tids.size()));
      }
    }
    res.num_states = static_cast<int32_t>(subsets.size());
    return 0;
  }

 private:
  const Nfa& nfa_;
  const std::vector<double>& beta_;
  double lm_, acwt_, limit_;
};

// exact best completion cost to the final state per NFA state, the states
// taken by falling rank (ties in increasing id, a stable sort)
std::vector<double> completion(const Nfa& nfa, double lm, double acwt) {
  const int32_t n = static_cast<int32_t>(nfa.arcs.size());
  std::vector<double> beta(n, std::numeric_limits<double>::infinity());
  beta[nfa.final_state] = 0.0;
  std::vector<int32_t> order(n);
  for (int32_t i = 0; i < n; ++i) order[i] = i;
  std::stable_sort(order.begin(), order.end(),
                   [&nfa](int32_t a, int32_t b) { return nfa.rank[a] > nfa.rank[b]; });
  for (int32_t q : order)
    for (const Arc& a : nfa.arcs[q]) {
      double c = a.gc * lm + a.ac * acwt + beta[a.dst];
      if (c < beta[q]) beta[q] = c;
    }
  return beta;
}

}  // namespace

extern "C" {

// Determinize one lattice.  Inputs, as lat/determinize.py's _build_nfa reads
// them: the start entries (graph state, cost, word sequence); nf frames whose
// arcs are [bounds[t], bounds[t+1]) of src, dst, gcost, acost, tid, oseq; the
// word sequences as offsets [num_oseqs + 1] into words; the candidate final
// states (graph state, final cost, word sequence or -1 for none).
// *out receives a result for vb_det_sizes / vb_det_fetch / vb_det_free.
// Returns 0; 1 past max_states (no result); 2 when nothing is within reach of
// the final state (an empty lattice, no result).
int vb_det_run(int64_t num_start, const int32_t* start_state, const double* start_cost,
               const int32_t* start_oseq, int32_t nf, const int64_t* bounds,
               const int32_t* src, const int32_t* dst, const double* gcost, const double* acost,
               const int32_t* tid, const int32_t* oseq, const int64_t* oseq_off,
               const int32_t* oseq_words, int64_t num_final, const int32_t* final_state,
               const double* final_cost, const int32_t* final_oseq, double beam, double lm,
               double acwt, int64_t max_states, void** out) {
  *out = nullptr;
  Nfa nfa;
  nfa.add_state(0);  // the superstart
  std::vector<std::pair<int64_t, int32_t>> created;  // (t, graph state) in order
  std::unordered_map<int64_t, int32_t> state_of;
  auto get_state = [&](int64_t t, int32_t s) {
    int64_t key = t * (int64_t(1) << 32) + static_cast<uint32_t>(s);
    auto it = state_of.find(key);
    if (it != state_of.end()) return it->second;
    int32_t q = nfa.add_state(2 + 2 * t);
    state_of.emplace(key, q);
    created.push_back({t, s});
    return q;
  };
  for (int64_t i = 0; i < num_start; ++i) {
    int32_t q = get_state(0, start_state[i]);
    int32_t o = start_oseq[i];
    nfa.add_word_seq(0, q, oseq_words + oseq_off[o], oseq_off[o + 1] - oseq_off[o],
                     start_cost[i], 0.0, -1, 1);
  }
  for (int32_t t = 0; t < nf; ++t)
    for (int64_t m = bounds[t]; m < bounds[t + 1]; ++m) {
      int32_t qs = get_state(t, src[m]);
      int32_t qd = get_state(t + 1, dst[m]);
      int32_t o = oseq[m];
      nfa.add_word_seq(qs, qd, oseq_words + oseq_off[o], oseq_off[o + 1] - oseq_off[o],
                       gcost[m], acost[m], tid[m], 3 + 2 * int64_t(t));
    }
  nfa.final_state = nfa.add_state(2 + 2 * int64_t(nf) + 2);
  std::unordered_map<int32_t, int64_t> final_at;
  for (int64_t i = 0; i < num_final; ++i) final_at.emplace(final_state[i], i);
  for (const auto& ts : created) {
    if (ts.first != nf) continue;
    auto it = final_at.find(ts.second);
    if (it == final_at.end()) continue;
    double fc = final_cost[it->second];
    if (!std::isfinite(fc)) continue;
    int32_t q = state_of[ts.first * (int64_t(1) << 32) + static_cast<uint32_t>(ts.second)];
    int32_t o = final_oseq[it->second];
    int64_t n = o < 0 ? 0 : oseq_off[o + 1] - oseq_off[o];
    nfa.add_word_seq(q, nfa.final_state, o < 0 ? nullptr : oseq_words + oseq_off[o], n, fc,
                     0.0, -1, 2 + 2 * int64_t(nf) + 1);
  }
  std::vector<double> beta = completion(nfa, lm, acwt);
  if (!std::isfinite(beta[0])) return 2;
  Determinizer det(nfa, beta, lm, acwt, beta[0] + beam);
  Result* res = new Result();
  if (det.run(max_states, *res) != 0) {
    delete res;
    return 1;
  }
  *out = res;
  return 0;
}

// sizes: states, arcs, arc tids, finals, final tids
void vb_det_sizes(void* h, int64_t* sizes) {
  const Result* r = static_cast<const Result*>(h);
  sizes[0] = r->num_states;
  sizes[1] = static_cast<int64_t>(r->src.size());
  sizes[2] = static_cast<int64_t>(r->tids.size());
  sizes[3] = static_cast<int64_t>(r->fin_state.size());
  sizes[4] = static_cast<int64_t>(r->fin_tids.size());
}

void vb_det_fetch(void* h, int32_t* src, int32_t* dst, int32_t* word, double* gc, double* ac,
                  int64_t* tid_off, int32_t* tids, int32_t* fin_state, double* fin_gc,
                  double* fin_ac, int64_t* fin_off, int32_t* fin_tids) {
  const Result* r = static_cast<const Result*>(h);
  std::copy(r->src.begin(), r->src.end(), src);
  std::copy(r->dst.begin(), r->dst.end(), dst);
  std::copy(r->word.begin(), r->word.end(), word);
  std::copy(r->gc.begin(), r->gc.end(), gc);
  std::copy(r->ac.begin(), r->ac.end(), ac);
  std::copy(r->tid_off.begin(), r->tid_off.end(), tid_off);
  std::copy(r->tids.begin(), r->tids.end(), tids);
  std::copy(r->fin_state.begin(), r->fin_state.end(), fin_state);
  std::copy(r->fin_gc.begin(), r->fin_gc.end(), fin_gc);
  std::copy(r->fin_ac.begin(), r->fin_ac.end(), fin_ac);
  std::copy(r->fin_off.begin(), r->fin_off.end(), fin_off);
  std::copy(r->fin_tids.begin(), r->fin_tids.end(), fin_tids);
}

void vb_det_free(void* h) { delete static_cast<Result*>(h); }

}  // extern "C"
