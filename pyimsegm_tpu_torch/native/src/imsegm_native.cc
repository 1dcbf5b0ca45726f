// Native host components of the PyTorch port of pyimsegm-tpu.
//
// The device compute path lives in CUDA and PyTorch; these host-side C++ routines cover
// the parts that are inherently sequential/pointer-chasing and that the
// reference implemented natively (Cython + the external C++ GCO library):
//
//  * enforce_connectivity — union-find connected components + small-fragment
//    merging over a SLIC label map (replaces skimage's Cython
//    `_enforce_label_connectivity`, used by
//    imsegm/superpixels.py:61-63 via enforce_connectivity=True).
//  * alpha_expansion — exact multi-label MRF minimisation via alpha-expansion
//    with Dinic max-flow (replaces the external gco `cut_general_graph`,
//    imsegm/graph_cuts.py:735-744).  Used as the validation
//    oracle for the on-device mean-field/ICM solver and as a host fallback.
//
// Plain C ABI; loaded from Python with ctypes.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <limits>
#include <queue>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Connected components + fragment merging on a 2D conn4 label grid.
// Components >= min_size keep a fresh sequential label (in raster order of
// their first pixel); smaller fragments merge into the *most-contact*
// already-relabelled adjacent component — contact counted as the number of
// distinct adjacent cells, ties to the smallest output label — matching
// skimage's _enforce_label_connectivity_cython semantics (the reference
// always runs it, imsegm/superpixels.py:61-63).
// Returns the number of output labels.
int enforce_connectivity_2d(const int32_t* labels, int h, int w,
                            int min_size, int32_t* out) {
  const int n = h * w;
  std::fill(out, out + n, -1);
  std::vector<int> stack;
  stack.reserve(1024);
  std::vector<int> comp_pixels;
  comp_pixels.reserve(4096);
  std::vector<int> nb_stamp(n, -1);  // component serial that counted cell q
  std::vector<int> cnt(n, 0);        // contact count per output label
  std::vector<int> contact_ids;      // distinct adjacent output labels
  int next_label = 0;
  int comp_serial = 0;
  const int dr[4] = {-1, 1, 0, 0};
  const int dc[4] = {0, 0, -1, 1};

  for (int start = 0; start < n; ++start) {
    if (out[start] != -1) continue;
    // flood fill the component of labels[start] containing start
    const int32_t lab = labels[start];
    stack.clear();
    comp_pixels.clear();
    contact_ids.clear();
    stack.push_back(start);
    out[start] = next_label;
    comp_pixels.push_back(start);
    while (!stack.empty()) {
      const int p = stack.back();
      stack.pop_back();
      const int r = p / w, c = p % w;
      for (int k = 0; k < 4; ++k) {
        const int rr = r + dr[k], cc = c + dc[k];
        if (rr < 0 || rr >= h || cc < 0 || cc >= w) continue;
        const int q = rr * w + cc;
        if (labels[q] == lab) {
          if (out[q] == -1) {
            out[q] = next_label;
            comp_pixels.push_back(q);
            stack.push_back(q);
          }
        } else if (out[q] >= 0 && nb_stamp[q] != comp_serial) {
          nb_stamp[q] = comp_serial;
          if (cnt[out[q]]++ == 0) contact_ids.push_back(out[q]);
        }
      }
    }
    if (static_cast<int>(comp_pixels.size()) < min_size
        && !contact_ids.empty()) {
      int best = -1, best_cnt = -1;
      for (const int id : contact_ids) {
        if (cnt[id] > best_cnt || (cnt[id] == best_cnt && id < best)) {
          best = id;
          best_cnt = cnt[id];
        }
      }
      for (const int p : comp_pixels) out[p] = best;
    } else {
      ++next_label;
    }
    for (const int id : contact_ids) cnt[id] = 0;
    ++comp_serial;
  }
  return next_label;
}

// ---------------------------------------------------------------------------
// Dinic max-flow on a small graph (s = node 0, t = node 1).
namespace {

struct Dinic {
  struct Arc { int to; double cap; int rev; };
  std::vector<std::vector<Arc>> g;
  std::vector<int> level, iter;
  explicit Dinic(int n) : g(n), level(n), iter(n) {}

  void add_edge(int a, int b, double cap_ab, double cap_ba) {
    g[a].push_back({b, cap_ab, static_cast<int>(g[b].size())});
    g[b].push_back({a, cap_ba, static_cast<int>(g[a].size()) - 1});
  }

  bool bfs(int s, int t) {
    std::fill(level.begin(), level.end(), -1);
    std::queue<int> q;
    level[s] = 0;
    q.push(s);
    while (!q.empty()) {
      const int v = q.front();
      q.pop();
      for (const Arc& a : g[v]) {
        if (a.cap > 1e-12 && level[a.to] < 0) {
          level[a.to] = level[v] + 1;
          q.push(a.to);
        }
      }
    }
    return level[t] >= 0;
  }

  double dfs(int v, int t, double f) {
    if (v == t) return f;
    for (int& i = iter[v]; i < static_cast<int>(g[v].size()); ++i) {
      Arc& a = g[v][i];
      if (a.cap > 1e-12 && level[v] < level[a.to]) {
        const double d = dfs(a.to, t, std::min(f, a.cap));
        if (d > 0) {
          a.cap -= d;
          g[a.to][a.rev].cap += d;
          return d;
        }
      }
    }
    return 0;
  }

  double max_flow(int s, int t) {
    double flow = 0;
    while (bfs(s, t)) {
      std::fill(iter.begin(), iter.end(), 0);
      double f;
      while ((f = dfs(s, t, std::numeric_limits<double>::max())) > 0) flow += f;
    }
    return flow;
  }

  // nodes reachable from s in the residual graph (source side of min cut)
  void min_cut_source_side(int s, std::vector<char>* in_s) {
    std::fill(in_s->begin(), in_s->end(), 0);
    std::queue<int> q;
    (*in_s)[s] = 1;
    q.push(s);
    while (!q.empty()) {
      const int v = q.front();
      q.pop();
      for (const Arc& a : g[v]) {
        if (a.cap > 1e-12 && !(*in_s)[a.to]) {
          (*in_s)[a.to] = 1;
          q.push(a.to);
        }
      }
    }
  }
};

double labeling_energy(int n_nodes, int n_edges, int n_labels,
                       const int32_t* edges, const double* weights,
                       const double* unary, const double* pairwise,
                       const int32_t* labels) {
  double e = 0;
  for (int i = 0; i < n_nodes; ++i) e += unary[i * n_labels + labels[i]];
  for (int j = 0; j < n_edges; ++j) {
    const int a = edges[2 * j], b = edges[2 * j + 1];
    e += weights[j] * pairwise[labels[a] * n_labels + labels[b]];
  }
  return e;
}

}  // namespace

// Alpha-expansion over a general weighted graph with label-pair costs.
// edges: (n_edges, 2) int32; weights: (n_edges,); unary: (n_nodes, n_labels);
// pairwise: (n_labels, n_labels) (should be metric-ish; clipped >= 0).
// labels_io: in = initial labeling (e.g. unary argmin), out = result.
// n_iter < 0 means iterate to convergence.  Returns final energy.
double alpha_expansion(int n_nodes, int n_edges, int n_labels,
                       const int32_t* edges, const double* weights,
                       const double* unary, const double* pairwise,
                       int n_iter, int32_t* labels_io) {
  std::vector<int32_t> labels(labels_io, labels_io + n_nodes);
  double best_e = labeling_energy(n_nodes, n_edges, n_labels, edges, weights,
                                  unary, pairwise, labels.data());
  const int max_sweeps = n_iter < 0 ? 100 : n_iter;
  auto pw = [&](int a, int b) {
    return std::max(pairwise[a * n_labels + b], 0.0);
  };

  for (int sweep = 0; sweep < max_sweeps; ++sweep) {
    bool changed = false;
    for (int alpha = 0; alpha < n_labels; ++alpha) {
      // build expansion graph: 0 = source(alpha), 1 = sink(current labels)
      const int first_aux = 2 + n_nodes;
      int n_aux = 0;
      for (int j = 0; j < n_edges; ++j) {
        if (labels[edges[2 * j]] != labels[edges[2 * j + 1]]) ++n_aux;
      }
      Dinic din(first_aux + n_aux);
      for (int i = 0; i < n_nodes; ++i) {
        const double d_alpha = unary[i * n_labels + alpha];
        const double d_cur = unary[i * n_labels + labels[i]];
        din.add_edge(0, 2 + i, d_alpha, 0);  // cut if i ends on sink side
        din.add_edge(2 + i, 1, d_cur, 0);    // cut if i ends on source side
      }
      int aux = first_aux;
      for (int j = 0; j < n_edges; ++j) {
        const int p = edges[2 * j], q = edges[2 * j + 1];
        const double w = weights[j];
        if (w <= 0) continue;
        const int lp = labels[p], lq = labels[q];
        if (lp == lq) {
          const double c = w * pw(lp, alpha);
          if (c > 0) din.add_edge(2 + p, 2 + q, c, c);
        } else {
          const double cpa = w * pw(lp, alpha);
          const double caq = w * pw(alpha, lq);
          const double cpq = w * pw(lp, lq);
          din.add_edge(2 + p, aux, cpa, cpa);
          din.add_edge(aux, 2 + q, caq, caq);
          din.add_edge(aux, 1, cpq, 0);
          ++aux;
        }
      }
      din.max_flow(0, 1);
      std::vector<char> in_s(first_aux + n_aux);
      din.min_cut_source_side(0, &in_s);
      std::vector<int32_t> new_labels(labels);
      for (int i = 0; i < n_nodes; ++i) {
        // sink side (not reachable from source) -> pays source arc -> alpha
        if (!in_s[2 + i]) new_labels[i] = alpha;
      }
      const double e = labeling_energy(n_nodes, n_edges, n_labels, edges,
                                       weights, unary, pairwise,
                                       new_labels.data());
      if (e < best_e - 1e-9) {
        best_e = e;
        labels = std::move(new_labels);
        changed = true;
      }
    }
    if (!changed) break;
  }
  std::memcpy(labels_io, labels.data(), n_nodes * sizeof(int32_t));
  return best_e;
}

}  // extern "C"
