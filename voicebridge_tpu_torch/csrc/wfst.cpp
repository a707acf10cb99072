// Native WFST kernels: composition, determinize-star, encoded minimization,
// connection — the performance-critical host-side graph algorithms.
//
// Role: the reference's graph side is native C++ (OpenFst + Kaldi fstext,
// SURVEY.md §2.2/§2.4).  This library provides the same algorithms over a
// flat SoA graph representation, exposed through a C ABI consumed from
// Python via ctypes (fst/native_bridge.py).  Semantics match
// the Python implementations in fst/ exactly (they are
// cross-checked by tests/test_torch_hostcopy.py); graphs at LibriSpeech scale
// compile ~50-100x faster here than in pure Python.
//
// Build: fst/native_bridge.py compiles this file with g++ at first use.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <map>
#include <queue>
#include <set>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr float kInf = std::numeric_limits<float>::infinity();
constexpr int kEps = 0;

struct Arc {
  int32_t ilabel, olabel;
  float weight;
  int32_t dst;
};

struct Graph {
  int32_t start = -1;
  std::vector<float> finals;               // kInf = not final
  std::vector<std::vector<Arc>> arcs;      // per state

  int32_t AddState() {
    finals.push_back(kInf);
    arcs.emplace_back();
    return static_cast<int32_t>(arcs.size()) - 1;
  }
  size_t NumArcs() const {
    size_t n = 0;
    for (const auto& v : arcs) n += v.size();
    return n;
  }
};

// ---------------------------------------------------------------------------
// C ABI marshalling
// ---------------------------------------------------------------------------

struct CGraph {
  int32_t num_states;
  int32_t start;
  int64_t num_arcs;
  // parallel arc arrays
  int32_t* src;
  int32_t* ilabel;
  int32_t* olabel;
  float* weight;
  int32_t* dst;
  float* finals;  // [num_states], +inf = not final
};

Graph FromC(const CGraph* g) {
  Graph out;
  out.start = g->start;
  out.finals.assign(g->finals, g->finals + g->num_states);
  out.arcs.resize(g->num_states);
  for (int64_t i = 0; i < g->num_arcs; ++i) {
    out.arcs[g->src[i]].push_back(
        Arc{g->ilabel[i], g->olabel[i], g->weight[i], g->dst[i]});
  }
  return out;
}

void ToC(const Graph& g, CGraph* out) {
  out->num_states = static_cast<int32_t>(g.arcs.size());
  out->start = g.start;
  int64_t na = static_cast<int64_t>(g.NumArcs());
  out->num_arcs = na;
  out->src = static_cast<int32_t*>(malloc(sizeof(int32_t) * na));
  out->ilabel = static_cast<int32_t*>(malloc(sizeof(int32_t) * na));
  out->olabel = static_cast<int32_t*>(malloc(sizeof(int32_t) * na));
  out->weight = static_cast<float*>(malloc(sizeof(float) * na));
  out->dst = static_cast<int32_t*>(malloc(sizeof(int32_t) * na));
  out->finals = static_cast<float*>(malloc(sizeof(float) * g.arcs.size()));
  int64_t k = 0;
  for (size_t s = 0; s < g.arcs.size(); ++s) {
    out->finals[s] = g.finals[s];
    for (const Arc& a : g.arcs[s]) {
      out->src[k] = static_cast<int32_t>(s);
      out->ilabel[k] = a.ilabel;
      out->olabel[k] = a.olabel;
      out->weight[k] = a.weight;
      out->dst[k] = a.dst;
      ++k;
    }
  }
}

// ---------------------------------------------------------------------------
// connect (trim)
// ---------------------------------------------------------------------------

void Connect(Graph* g) {
  size_t n = g->arcs.size();
  if (g->start < 0 || n == 0) {
    g->arcs.clear();
    g->finals.clear();
    g->start = -1;
    return;
  }
  std::vector<char> fwd(n, 0), bwd(n, 0);
  std::vector<int32_t> stack{g->start};
  fwd[g->start] = 1;
  while (!stack.empty()) {
    int32_t s = stack.back();
    stack.pop_back();
    for (const Arc& a : g->arcs[s])
      if (!fwd[a.dst]) {
        fwd[a.dst] = 1;
        stack.push_back(a.dst);
      }
  }
  std::vector<std::vector<int32_t>> radj(n);
  for (size_t s = 0; s < n; ++s)
    if (fwd[s])
      for (const Arc& a : g->arcs[s]) radj[a.dst].push_back(s);
  for (size_t s = 0; s < n; ++s)
    if (fwd[s] && g->finals[s] != kInf) {
      bwd[s] = 1;
      stack.push_back(s);
    }
  while (!stack.empty()) {
    int32_t s = stack.back();
    stack.pop_back();
    for (int32_t p : radj[s])
      if (!bwd[p]) {
        bwd[p] = 1;
        stack.push_back(p);
      }
  }
  std::vector<int32_t> remap(n, -1);
  int32_t next = 0;
  for (size_t s = 0; s < n; ++s)
    if (fwd[s] && bwd[s]) remap[s] = next++;
  Graph out;
  out.finals.resize(next, kInf);
  out.arcs.resize(next);
  for (size_t s = 0; s < n; ++s) {
    if (remap[s] < 0) continue;
    out.finals[remap[s]] = g->finals[s];
    for (const Arc& a : g->arcs[s])
      if (remap[a.dst] >= 0)
        out.arcs[remap[s]].push_back(
            Arc{a.ilabel, a.olabel, a.weight, remap[a.dst]});
  }
  out.start = (g->start >= 0 && remap[g->start] >= 0) ? remap[g->start] : -1;
  *g = std::move(out);
}

// ---------------------------------------------------------------------------
// compose with 3-state epsilon filter (matches fst/compose.py)
// ---------------------------------------------------------------------------

void Compose(const Graph& a, const Graph& b, Graph* out) {
  if (a.start < 0 || b.start < 0) return;
  // b arcs sorted by ilabel
  std::vector<std::vector<Arc>> bs(b.arcs.size());
  for (size_t s = 0; s < b.arcs.size(); ++s) {
    bs[s] = b.arcs[s];
    std::sort(bs[s].begin(), bs[s].end(),
              [](const Arc& x, const Arc& y) { return x.ilabel < y.ilabel; });
  }
  struct Key {
    int32_t s1, s2, f;
    bool operator==(const Key& o) const {
      return s1 == o.s1 && s2 == o.s2 && f == o.f;
    }
  };
  struct KeyHash {
    size_t operator()(const Key& k) const {
      return (static_cast<size_t>(k.s1) * 1000003u) ^
             (static_cast<size_t>(k.s2) * 97u) ^ k.f;
    }
  };
  std::unordered_map<Key, int32_t, KeyHash> ids;
  std::vector<Key> stack;
  auto GetState = [&](Key k) {
    auto it = ids.find(k);
    if (it != ids.end()) return it->second;
    int32_t id = out->AddState();
    ids.emplace(k, id);
    stack.push_back(k);
    return id;
  };
  out->start = GetState({a.start, b.start, 0});
  while (!stack.empty()) {
    Key k = stack.back();
    stack.pop_back();
    int32_t s = ids[k];
    float f1 = a.finals[k.s1], f2 = b.finals[k.s2];
    if (f1 != kInf && f2 != kInf) out->finals[s] = f1 + f2;
    const auto& arcs2 = bs[k.s2];
    auto lo_eps = std::lower_bound(
        arcs2.begin(), arcs2.end(), kEps,
        [](const Arc& x, int l) { return x.ilabel < l; });
    for (const Arc& a1 : a.arcs[k.s1]) {
      if (a1.olabel == kEps) {
        if (k.f != 2) {
          // NOTE: GetState may reallocate out->arcs; never index out->arcs
          // in the same expression.
          int32_t ns = GetState({a1.dst, k.s2, 1});
          out->arcs[s].push_back(Arc{a1.ilabel, kEps, a1.weight, ns});
        }
        if (k.f == 0) {
          for (auto it = lo_eps; it != arcs2.end() && it->ilabel == kEps; ++it) {
            int32_t ns = GetState({a1.dst, it->dst, 0});
            out->arcs[s].push_back(
                Arc{a1.ilabel, it->olabel, a1.weight + it->weight, ns});
          }
        }
      } else {
        auto lo = std::lower_bound(
            arcs2.begin(), arcs2.end(), a1.olabel,
            [](const Arc& x, int l) { return x.ilabel < l; });
        for (auto it = lo; it != arcs2.end() && it->ilabel == a1.olabel; ++it) {
          int32_t ns = GetState({a1.dst, it->dst, 0});
          out->arcs[s].push_back(
              Arc{a1.ilabel, it->olabel, a1.weight + it->weight, ns});
        }
      }
    }
    if (k.f != 1) {
      for (auto it = lo_eps; it != arcs2.end() && it->ilabel == kEps; ++it) {
        int32_t ns = GetState({k.s1, it->dst, 2});
        out->arcs[s].push_back(Arc{kEps, it->olabel, it->weight, ns});
      }
    }
  }
  Connect(out);
}

// ---------------------------------------------------------------------------
// determinize-star (matches fst/determinize.py)
// ---------------------------------------------------------------------------

double LogPlus(double x, double y) {  // cost domain
  if (x == kInf) return y;
  if (y == kInf) return x;
  double m = std::min(x, y);
  return m - std::log1p(std::exp(m - std::max(x, y)));
}

using OString = std::vector<int32_t>;

struct Element {
  int32_t state;
  OString ostr;
  bool operator<(const Element& o) const {
    if (state != o.state) return state < o.state;
    return ostr < o.ostr;
  }
  bool operator==(const Element& o) const {
    return state == o.state && ostr == o.ostr;
  }
};

using Subset = std::map<Element, double>;  // element -> weight

std::string SubsetKey(const Subset& s) {
  std::string key;
  key.reserve(s.size() * 16);
  char buf[32];
  for (const auto& [el, w] : s) {
    snprintf(buf, sizeof(buf), "%d:%.5f:", el.state, w);
    key += buf;
    for (int32_t o : el.ostr) {
      snprintf(buf, sizeof(buf), "%d,", o);
      key += buf;
    }
    key += ';';
  }
  return key;
}

int DeterminizeStar(const Graph& in, bool use_log, Graph* out) {
  if (in.start < 0) return 0;
  auto Plus = [&](double x, double y) {
    return use_log ? LogPlus(x, y) : std::min(x, y);
  };

  auto EpsClosure = [&](Subset elems) {
    std::vector<std::pair<Element, double>> queue(elems.begin(), elems.end());
    long iters = 0;
    while (!queue.empty()) {
      auto [el, w] = queue.back();
      queue.pop_back();
      if (++iters > 10000000L) return Subset();  // eps cycle -> error
      for (const Arc& a : in.arcs[el.state]) {
        if (a.ilabel != kEps) continue;
        Element ne{a.dst, el.ostr};
        if (a.olabel != kEps) ne.ostr.push_back(a.olabel);
        double nw = w + a.weight;
        auto it = elems.find(ne);
        if (it == elems.end()) {
          elems.emplace(ne, nw);
          queue.push_back({ne, nw});
        } else {
          double merged = Plus(it->second, nw);
          if (merged < it->second - 1e-9) {
            it->second = merged;
            queue.push_back({ne, merged});
          }
        }
      }
    }
    return elems;
  };

  struct Norm {
    std::string key;
    double weight;
    OString prefix;
    Subset canon;
  };
  auto Normalize = [&](const Subset& elems) {
    Norm n;
    n.weight = kInf;
    for (const auto& [el, w] : elems) n.weight = Plus(n.weight, w);
    bool first = true;
    for (const auto& [el, w] : elems) {
      if (first) {
        n.prefix = el.ostr;
        first = false;
      } else {
        size_t k = 0;
        while (k < n.prefix.size() && k < el.ostr.size() &&
               n.prefix[k] == el.ostr[k])
          ++k;
        n.prefix.resize(k);
      }
    }
    for (const auto& [el, w] : elems) {
      Element ne{el.state,
                 OString(el.ostr.begin() + n.prefix.size(), el.ostr.end())};
      double rw = w - n.weight;
      auto it = n.canon.find(ne);
      if (it == n.canon.end())
        n.canon.emplace(ne, rw);
      else
        it->second = Plus(it->second, rw);
    }
    n.key = SubsetKey(n.canon);
    return n;
  };

  std::unordered_map<std::string, int32_t> subset_ids;
  std::vector<Subset> subsets;
  std::vector<int32_t> stack;
  auto GetSubset = [&](const Subset& canon, const std::string& key) {
    auto it = subset_ids.find(key);
    if (it != subset_ids.end()) return it->second;
    int32_t id = out->AddState();
    subset_ids.emplace(key, id);
    subsets.push_back(canon);
    stack.push_back(id);
    return id;
  };

  Subset start = EpsClosure({{{in.start, {}}, 0.0}});
  if (start.empty()) return -1;
  Norm sn = Normalize(start);
  if (!sn.prefix.empty() || sn.weight != 0.0) {
    Subset adj;
    for (const auto& [el, w] : sn.canon) {
      OString full = sn.prefix;
      full.insert(full.end(), el.ostr.begin(), el.ostr.end());
      adj.emplace(Element{el.state, full}, w + sn.weight);
    }
    sn.canon = adj;
    sn.prefix.clear();
    sn.weight = 0.0;
    sn.key = SubsetKey(sn.canon);
  }
  out->start = GetSubset(sn.canon, sn.key);

  struct LongArc {
    int32_t src, ilabel, dst;
    OString ostr;
    double weight;
  };
  std::vector<LongArc> long_arcs;
  struct FinalResidue {
    int32_t src;
    OString ostr;
    double weight;
  };
  std::vector<FinalResidue> residues;

  while (!stack.empty()) {
    int32_t sid = stack.back();
    stack.pop_back();
    Subset elements = subsets[sid];

    // finals
    std::map<OString, double> fin;
    for (const auto& [el, w] : elements) {
      float fw = in.finals[el.state];
      if (fw == kInf) continue;
      double tot = w + fw;
      auto it = fin.find(el.ostr);
      if (it == fin.end())
        fin.emplace(el.ostr, tot);
      else
        it->second = Plus(it->second, tot);
    }
    if (fin.size() > 1) return -2;  // diverging final outputs: not functional
    for (const auto& [o, w] : fin) {
      if (o.empty())
        out->finals[sid] = static_cast<float>(w);
      else
        residues.push_back({sid, o, w});
    }

    // group arcs by ilabel
    std::map<int32_t, Subset> by_ilabel;
    for (const auto& [el, w] : elements) {
      for (const Arc& a : in.arcs[el.state]) {
        if (a.ilabel == kEps) continue;
        Element ne{a.dst, el.ostr};
        if (a.olabel != kEps) ne.ostr.push_back(a.olabel);
        double nw = w + a.weight;
        Subset& d = by_ilabel[a.ilabel];
        auto it = d.find(ne);
        if (it == d.end())
          d.emplace(ne, nw);
        else
          it->second = Plus(it->second, nw);
      }
    }
    for (auto& [ilabel, elems] : by_ilabel) {
      Subset closed = EpsClosure(std::move(elems));
      if (closed.empty()) return -1;
      Norm n = Normalize(closed);
      int32_t dst = GetSubset(n.canon, n.key);
      if (n.prefix.size() <= 1) {
        int32_t ol = n.prefix.empty() ? kEps : n.prefix[0];
        out->arcs[sid].push_back(
            Arc{ilabel, ol, static_cast<float>(n.weight), dst});
      } else {
        long_arcs.push_back({sid, ilabel, dst, n.prefix, n.weight});
      }
    }
  }

  for (const LongArc& la : long_arcs) {
    int32_t s = la.src;
    for (size_t k = 0; k < la.ostr.size(); ++k) {
      bool last = (k + 1 == la.ostr.size());
      int32_t ns = last ? la.dst : out->AddState();
      out->arcs[s].push_back(Arc{k == 0 ? la.ilabel : kEps, la.ostr[k],
                                 k == 0 ? static_cast<float>(la.weight) : 0.0f,
                                 ns});
      s = ns;
    }
  }
  for (const FinalResidue& fr : residues) {
    int32_t s = fr.src;
    for (size_t k = 0; k < fr.ostr.size(); ++k) {
      int32_t ns = out->AddState();
      out->arcs[s].push_back(Arc{kEps, fr.ostr[k],
                                 k == 0 ? static_cast<float>(fr.weight) : 0.0f,
                                 ns});
      s = ns;
    }
    out->finals[s] = 0.0f;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// minimize-encoded (matches fst/minimize.py: Moore refinement)
// ---------------------------------------------------------------------------

void MinimizeEncoded(Graph* g) {
  Connect(g);
  size_t n = g->arcs.size();
  if (n == 0) return;
  // encode arcs
  std::map<std::tuple<int32_t, int32_t, int64_t>, int32_t> enc;
  auto Sym = [&](const Arc& a) {
    auto key = std::make_tuple(a.ilabel, a.olabel,
                               static_cast<int64_t>(std::llround(a.weight * 100000.0)));
    auto it = enc.find(key);
    if (it != enc.end()) return it->second;
    int32_t id = static_cast<int32_t>(enc.size());
    enc.emplace(key, id);
    return id;
  };
  std::vector<std::vector<std::pair<int32_t, int32_t>>> enc_arcs(n);
  for (size_t s = 0; s < n; ++s) {
    for (const Arc& a : g->arcs[s]) enc_arcs[s].push_back({Sym(a), a.dst});
    std::sort(enc_arcs[s].begin(), enc_arcs[s].end());
  }
  auto FKey = [&](size_t s) {
    return g->finals[s] == kInf
               ? std::numeric_limits<int64_t>::min()
               : static_cast<int64_t>(std::llround(g->finals[s] * 100000.0));
  };
  std::vector<int32_t> part(n);
  {
    std::map<int64_t, int32_t> init;
    for (size_t s = 0; s < n; ++s) {
      auto key = FKey(s);
      auto it = init.find(key);
      if (it == init.end()) it = init.emplace(key, (int32_t)init.size()).first;
      part[s] = it->second;
    }
  }
  size_t num_blocks = 0;
  for (int32_t p : part) num_blocks = std::max(num_blocks, (size_t)p + 1);
  while (true) {
    std::map<std::pair<int64_t, std::vector<std::pair<int32_t, int32_t>>>,
             int32_t>
        sigs;
    std::vector<int32_t> new_part(n);
    for (size_t s = 0; s < n; ++s) {
      std::vector<std::pair<int32_t, int32_t>> sig;
      sig.reserve(enc_arcs[s].size());
      for (auto [sym, dst] : enc_arcs[s]) sig.push_back({sym, part[dst]});
      auto key = std::make_pair(FKey(s), std::move(sig));
      auto it = sigs.find(key);
      if (it == sigs.end()) it = sigs.emplace(key, (int32_t)sigs.size()).first;
      new_part[s] = it->second;
    }
    if (sigs.size() == num_blocks) break;
    num_blocks = sigs.size();
    part = std::move(new_part);
  }
  Graph out;
  out.finals.resize(num_blocks, kInf);
  out.arcs.resize(num_blocks);
  std::vector<char> seen(num_blocks, 0);
  for (size_t s = 0; s < n; ++s) {
    int32_t b = part[s];
    if (seen[b]) continue;
    seen[b] = 1;
    out.finals[b] = g->finals[s];
    for (const Arc& a : g->arcs[s])
      out.arcs[b].push_back(Arc{a.ilabel, a.olabel, a.weight, part[a.dst]});
  }
  out.start = part[g->start];
  Connect(&out);
  *g = std::move(out);
}

// ---------------------------------------------------------------------------
// remove-eps-local: conservative (size-safe) eps:eps elimination
// (role: Kaldi RemoveEpsLocal, fstext/remove-eps-local.h; semantics match
// fst/epsilon.py remove_eps_local — two local rules applied
// to fixpoint — but with incremental in-degree / reverse-adjacency
// bookkeeping instead of the Python version's full rescan per change, which
// is what makes 100k-state HCLGa graphs compile in milliseconds, not minutes)
// ---------------------------------------------------------------------------

void RemoveEpsLocal(Graph* g) {
  const int32_t n = static_cast<int32_t>(g->arcs.size());
  if (n == 0) return;
  std::vector<int32_t> indeg(n, 0);
  // reverse adjacency as (state, arc-index) refs, validated lazily (a ref is
  // stale when the arc no longer points at the state)
  std::vector<std::vector<std::pair<int32_t, int32_t>>> incoming(n);
  for (int32_t s = 0; s < n; ++s)
    for (size_t i = 0; i < g->arcs[s].size(); ++i) {
      const Arc& a = g->arcs[s][i];
      ++indeg[a.dst];
      incoming[a.dst].push_back({s, static_cast<int32_t>(i)});
    }

  std::vector<char> queued(n, 1);
  std::vector<int32_t> work(n);
  for (int32_t s = 0; s < n; ++s) work[s] = n - 1 - s;  // process 0..n-1

  auto push = [&](int32_t s) {
    if (!queued[s]) {
      queued[s] = 1;
      work.push_back(s);
    }
  };

  while (!work.empty()) {
    int32_t s = work.back();
    work.pop_back();
    queued[s] = 0;
    bool local_change = true;
    while (local_change) {
      local_change = false;
      auto& arcs = g->arcs[s];
      for (size_t i = 0; i < arcs.size(); ++i) {
        Arc a = arcs[i];
        if (a.ilabel != kEps || a.olabel != kEps) continue;
        if (a.dst == s) {
          if (a.weight >= 0.0f) {  // non-negative eps self-loop: useless
            arcs.erase(arcs.begin() + i);
            --indeg[s];
            local_change = true;
            break;
          }
          continue;
        }
        int32_t d = a.dst;
        // rule 1: d's only incoming arc is this eps arc: absorb d into s
        if (indeg[d] == 1 && d != g->start) {
          arcs.erase(arcs.begin() + i);
          --indeg[d];
          for (const Arc& b : g->arcs[d]) {
            --indeg[b.dst];  // will be re-counted as s's arc
            arcs.push_back(Arc{b.ilabel, b.olabel, a.weight + b.weight, b.dst});
            ++indeg[arcs.back().dst];
            incoming[arcs.back().dst].push_back(
                {s, static_cast<int32_t>(arcs.size()) - 1});
            push(arcs.back().dst);
          }
          if (g->finals[d] != kInf) {
            float nf = a.weight + g->finals[d];
            g->finals[s] = std::min(g->finals[s], nf);
          }
          g->arcs[d].clear();
          g->finals[d] = kInf;
          local_change = true;
          break;
        }
        // rule 2: s's only arc is this eps arc, s non-final, not start:
        // splice s out by redirecting its incoming arcs to d.  The stored
        // (state, arc-index) refs can go stale after erases shift indices,
        // so only the STATE half is trusted: each unique predecessor is
        // re-scanned for arcs into s (out-degrees are small).
        if (arcs.size() == 1 && g->finals[s] == kInf && s != g->start) {
          std::vector<int32_t> preds;
          for (const auto& ref : incoming[s])
            if (ref.first != s) preds.push_back(ref.first);
          std::sort(preds.begin(), preds.end());
          preds.erase(std::unique(preds.begin(), preds.end()), preds.end());
          for (int32_t u : preds) {
            auto& uarcs = g->arcs[u];
            for (size_t j = 0; j < uarcs.size(); ++j) {
              if (uarcs[j].dst != s) continue;
              uarcs[j].dst = d;
              uarcs[j].weight += a.weight;
              --indeg[s];
              ++indeg[d];
              incoming[d].push_back({u, static_cast<int32_t>(j)});
            }
            push(u);
          }
          incoming[s].clear();
          arcs.clear();
          --indeg[d];
          push(d);
          local_change = true;
          break;
        }
      }
    }
  }
  Connect(g);
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

void vb_free_graph(CGraph* g) {
  free(g->src);
  free(g->ilabel);
  free(g->olabel);
  free(g->weight);
  free(g->dst);
  free(g->finals);
  memset(g, 0, sizeof(CGraph));
}

int vb_compose(const CGraph* a, const CGraph* b, CGraph* out) {
  Graph ga = FromC(a), gb = FromC(b), g;
  Compose(ga, gb, &g);
  ToC(g, out);
  return 0;
}

int vb_determinize_star(const CGraph* in, int use_log, CGraph* out) {
  Graph gi = FromC(in), g;
  int rc = DeterminizeStar(gi, use_log != 0, &g);
  if (rc != 0) return rc;
  ToC(g, out);
  return 0;
}

int vb_minimize_encoded(const CGraph* in, CGraph* out) {
  Graph g = FromC(in);
  MinimizeEncoded(&g);
  ToC(g, out);
  return 0;
}

int vb_remove_eps_local(const CGraph* in, CGraph* out) {
  Graph g = FromC(in);
  RemoveEpsLocal(&g);
  ToC(g, out);
  return 0;
}

int vb_connect(const CGraph* in, CGraph* out) {
  Graph g = FromC(in);
  Connect(&g);
  ToC(g, out);
  return 0;
}

}  // extern "C"
