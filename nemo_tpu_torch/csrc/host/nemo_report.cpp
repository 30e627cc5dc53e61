// Native figure-rendering engine: DOT graph layout -> SVG.
//
// The reference renders every figure by shelling out to graphviz's `dot -Tsvg`
// (report/webpage.go:65), a native C binary; this is the rebuild's native
// equivalent.  The layout algorithm is the same one as the portable Python
// renderer (nemo_tpu/report/svg.py) — longest-path layering, two barycenter
// ordering passes, straight-line edges — and the output is byte-identical to
// it (enforced by tests/test_report_native.py), so the Python path remains the
// parity oracle and fallback.
//
// ABI (ctypes, see nemo_tpu/report/native.py):
//   nemo_report_abi_version() -> int
//   nemo_render_svg(...)      -> malloc'd NUL-terminated SVG (caller frees
//                                with nemo_report_free)
// The caller resolves DOT attributes host-side and passes flat arrays:
// per node label/char-count/shape/style-flags/colors, per edge
// src/dst/color/style-flags, in original insertion order with invisible
// elements included (they participate in layout, matching svg.py).

#include <algorithm>
#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <locale.h>
#include <map>
#include <string>
#include <vector>

namespace {

constexpr double kCharW = 7.2;   // px per character at font-size 12
constexpr double kNodeH = 36.0;
constexpr double kLayerGap = 70.0;
constexpr double kXGap = 24.0;
constexpr double kMargin = 20.0;

constexpr unsigned kInvis = 1u;
constexpr unsigned kDashed = 2u;
constexpr unsigned kBold = 4u;

// Byte parity with the Python renderer requires '.'-decimal %f output no
// matter what LC_NUMERIC the embedding process has set; pin the C locale for
// the formatting call (thread-local, restored immediately).
locale_t c_locale() {
  static locale_t loc = newlocale(LC_ALL_MASK, "C", static_cast<locale_t>(nullptr));
  return loc;
}

void append_fmt(std::string& out, const char* fmt, ...) {
  locale_t prev = uselocale(c_locale());
  va_list ap;
  va_start(ap, fmt);
  char buf[512];
  va_list ap2;
  va_copy(ap2, ap);
  int n = vsnprintf(buf, sizeof(buf), fmt, ap2);
  va_end(ap2);
  if (n >= 0 && static_cast<size_t>(n) < sizeof(buf)) {
    out.append(buf, static_cast<size_t>(n));
  } else if (n > 0) {  // long %s interpolation: retry with an exact buffer
    std::vector<char> big(static_cast<size_t>(n) + 1);
    vsnprintf(big.data(), big.size(), fmt, ap);
    out.append(big.data(), static_cast<size_t>(n));
  }
  va_end(ap);
  uselocale(prev);
}

// Python html.escape(s) with quote=True, in its replacement order.
std::string html_escape(const char* s) {
  std::string out;
  for (const char* p = s; *p; ++p) {
    switch (*p) {
      case '&': out += "&amp;"; break;
      case '<': out += "&lt;"; break;
      case '>': out += "&gt;"; break;
      case '"': out += "&quot;"; break;
      case '\'': out += "&#x27;"; break;
      default: out += *p;
    }
  }
  return out;
}

}  // namespace

extern "C" {

int nemo_report_abi_version() { return 2; }

void nemo_report_free(char* p) { std::free(p); }

// node_cluster[i] = cluster ordinal of node i, or -1 (orders after all
// clusters); cluster_labels has n_clusters entries.  Clusters keep their
// member nodes contiguous per layer and draw as labeled boxes — the
// graphviz cluster semantics Molly's spacetime diagrams rely on.
char* nemo_render_svg(int n_nodes, const char** labels, const int32_t* label_chars,
                      const unsigned char* shape_rect, const unsigned char* node_flags,
                      const char** fill, const char** stroke, const char** fontcolor,
                      int n_edges, const int32_t* esrc, const int32_t* edst,
                      const char** ecolor, const unsigned char* edge_flags,
                      int n_clusters, const char** cluster_labels,
                      const int32_t* node_cluster) {
  // Longest-path layering (svg.py:36-57).  Self-loops are excluded from the
  // layering adjacency but still drawn and still count as predecessors for
  // the barycenter, matching the Python renderer.
  std::vector<std::vector<int>> out(n_nodes);
  std::vector<int> indeg(n_nodes, 0);
  for (int e = 0; e < n_edges; ++e) {
    if (esrc[e] != edst[e]) {
      out[esrc[e]].push_back(edst[e]);
      indeg[edst[e]]++;
    }
  }
  std::vector<int> layer(n_nodes, -1);
  std::vector<int> stack;
  for (int i = 0; i < n_nodes; ++i) {
    if (indeg[i] == 0) {
      layer[i] = 0;
      stack.push_back(i);
    }
  }
  std::vector<int> remaining = indeg;
  while (!stack.empty()) {
    int v = stack.back();
    stack.pop_back();
    for (int w : out[v]) {
      layer[w] = std::max(layer[w], layer[v] + 1);
      if (--remaining[w] == 0) stack.push_back(w);
    }
  }
  for (int i = 0; i < n_nodes; ++i) {  // cycle leftovers -> layer 0
    if (layer[i] < 0) layer[i] = 0;
  }

  std::map<int, std::vector<int>> by_layer;  // ascending layer == sorted(by_layer)
  for (int i = 0; i < n_nodes; ++i) by_layer[layer[i]].push_back(i);

  // Two barycenter passes (svg.py:64-78).  Keys are computed against the
  // positions as of the start of each layer's sort, then a stable sort —
  // exactly Python's list.sort(key=...).
  std::vector<double> pos(n_nodes, 0.0);
  for (auto& [li, row] : by_layer) {
    for (size_t i = 0; i < row.size(); ++i) pos[row[i]] = static_cast<double>(i);
  }
  std::vector<std::vector<int>> preds(n_nodes);
  for (int e = 0; e < n_edges; ++e) preds[edst[e]].push_back(esrc[e]);
  // Rank tuple (cluster, barycenter): cluster members stay contiguous per
  // layer (svg.py cluster_rank; -1 = no cluster, after all clusters).
  auto rank_of = [&](int node) {
    int32_t c = node_cluster ? node_cluster[node] : -1;
    return c < 0 ? n_clusters : static_cast<int>(c);
  };
  for (int pass = 0; pass < 2; ++pass) {
    for (auto& [li, row] : by_layer) {
      std::vector<double> key(row.size());
      for (size_t i = 0; i < row.size(); ++i) {
        const auto& ps = preds[row[i]];
        if (ps.empty()) {
          key[i] = pos[row[i]];
        } else {
          double s = 0.0;
          for (int p : ps) s += pos[p];
          key[i] = s / static_cast<double>(ps.size());
        }
      }
      std::vector<int> idx(row.size());
      for (size_t i = 0; i < idx.size(); ++i) idx[i] = static_cast<int>(i);
      std::stable_sort(idx.begin(), idx.end(), [&](int a, int b) {
        int ra = rank_of(row[a]), rb = rank_of(row[b]);
        if (ra != rb) return ra < rb;
        return key[a] < key[b];
      });
      std::vector<int> sorted(row.size());
      for (size_t i = 0; i < idx.size(); ++i) sorted[i] = row[idx[i]];
      row = std::move(sorted);
      for (size_t i = 0; i < row.size(); ++i) pos[row[i]] = static_cast<double>(i);
    }
  }

  // Coordinates (svg.py:80-103).
  std::vector<double> node_w(n_nodes), cx(n_nodes), cy(n_nodes);
  for (int i = 0; i < n_nodes; ++i) {
    node_w[i] = std::max(60.0, kCharW * label_chars[i] + 16.0);
  }
  double width = 2 * kMargin;
  for (auto& [li, row] : by_layer) {
    double x = kMargin;
    for (int n : row) {
      cx[n] = x + node_w[n] / 2;
      cy[n] = kMargin + li * kLayerGap + kNodeH / 2;
      x += node_w[n] + kXGap;
    }
    width = std::max(width, x + kMargin);
  }
  int max_layer = by_layer.empty() ? 0 : by_layer.rbegin()->first;
  double height = 2 * kMargin + (max_layer + 1) * kLayerGap;
  for (auto& [li, row] : by_layer) {
    if (row.empty()) continue;
    double row_w = kXGap * (row.size() - 1);
    for (int n : row) row_w += node_w[n];
    double shift = (width - 2 * kMargin - row_w) / 2;
    for (int n : row) cx[n] += shift;
  }

  // SVG emission (svg.py:105-166): header, visible edges in input order,
  // visible nodes in (layer, in-layer) order, "\n"-joined.
  std::string svg;
  svg.reserve(256 + 160 * static_cast<size_t>(n_nodes + n_edges));
  append_fmt(svg,
             "<svg xmlns=\"http://www.w3.org/2000/svg\" width=\"%.0f\" height=\"%.0f\" "
             "viewBox=\"0 0 %.0f %.0f\">",
             width, height, width, height);
  svg +=
      "\n<defs><marker id='arrow' markerWidth='10' markerHeight='8' refX='9' refY='4' "
      "orient='auto'><path d='M0,0 L10,4 L0,8 z' fill='#444'/></marker></defs>";

  // Cluster boxes (svg.py: bounding box of members + 8px padding, labeled
  // top-left inside the box), drawn under edges and nodes.
  for (int c = 0; c < n_clusters; ++c) {
    bool any = false;
    double x0 = 0, x1 = 0, y0 = 0, y1 = 0;
    for (int i = 0; i < n_nodes; ++i) {
      if (!node_cluster || node_cluster[i] != c) continue;
      double nx0 = cx[i] - node_w[i] / 2, nx1 = cx[i] + node_w[i] / 2;
      double ny0 = cy[i] - kNodeH / 2, ny1 = cy[i] + kNodeH / 2;
      if (!any) {
        x0 = nx0; x1 = nx1; y0 = ny0; y1 = ny1;
        any = true;
      } else {
        x0 = std::min(x0, nx0); x1 = std::max(x1, nx1);
        y0 = std::min(y0, ny0); y1 = std::max(y1, ny1);
      }
    }
    if (!any) continue;
    x0 -= 8; x1 += 8; y0 -= 8; y1 += 8;
    append_fmt(svg,
               "\n<rect x=\"%.1f\" y=\"%.1f\" width=\"%.1f\" height=\"%.1f\" "
               "fill=\"none\" stroke=\"#999\" stroke-width=\"1\"/>",
               x0, y0, x1 - x0, y1 - y0);
    append_fmt(svg,
               "\n<text x=\"%.1f\" y=\"%.1f\" font-family=\"monospace\" "
               "font-size=\"10\" fill=\"#555\">",
               x0 + 4, y0 + 12);
    svg += html_escape(cluster_labels[c]);
    svg += "</text>";
  }

  for (int e = 0; e < n_edges; ++e) {
    if (edge_flags[e] & kInvis) continue;
    double x1 = cx[esrc[e]], y1 = cy[esrc[e]] + kNodeH / 2;
    double x2 = cx[edst[e]], y2 = cy[edst[e]] - kNodeH / 2;
    const char* dash = (edge_flags[e] & kDashed) ? " stroke-dasharray=\"6,3\"" : "";
    append_fmt(svg,
               "\n<line x1=\"%.1f\" y1=\"%.1f\" x2=\"%.1f\" y2=\"%.1f\" stroke=\"%s\" "
               "stroke-width=\"1.2\"%s marker-end=\"url(#arrow)\"/>",
               x1, y1, x2, y2, ecolor[e], dash);
  }

  for (auto& [li, row] : by_layer) {
    for (int n : row) {
      if (node_flags[n] & kInvis) continue;
      double w = node_w[n];
      const char* stroke_w = (node_flags[n] & kBold) ? "2.4" : "1.2";
      const char* dash = (node_flags[n] & kDashed) ? " stroke-dasharray=\"6,3\"" : "";
      if (shape_rect[n]) {
        append_fmt(svg,
                   "\n<rect x=\"%.1f\" y=\"%.1f\" width=\"%.1f\" height=\"%.1f\" rx=\"3\" "
                   "fill=\"%s\" stroke=\"%s\" stroke-width=\"%s\"%s/>",
                   cx[n] - w / 2, cy[n] - kNodeH / 2, w, kNodeH, fill[n], stroke[n],
                   stroke_w, dash);
      } else {
        append_fmt(svg,
                   "\n<ellipse cx=\"%.1f\" cy=\"%.1f\" rx=\"%.1f\" ry=\"%.1f\" "
                   "fill=\"%s\" stroke=\"%s\" stroke-width=\"%s\"%s/>",
                   cx[n], cy[n], w / 2, kNodeH / 2, fill[n], stroke[n], stroke_w, dash);
      }
      append_fmt(svg,
                 "\n<text x=\"%.1f\" y=\"%.1f\" text-anchor=\"middle\" "
                 "font-family=\"monospace\" font-size=\"12\" fill=\"%s\">",
                 cx[n], cy[n] + 4, fontcolor[n]);
      svg += html_escape(labels[n]);
      svg += "</text>";
    }
  }
  svg += "\n</svg>";

  char* result = static_cast<char*>(std::malloc(svg.size() + 1));
  if (!result) return nullptr;
  std::memcpy(result, svg.c_str(), svg.size() + 1);
  return result;
}

}  // extern "C"
