// gtnative: host-side sequential kernels for genometools_tpu.
//
// The device side is purely data-parallel (sort/scan/histogram/DP in
// JAX); the traversals that are sequential-by-nature — bottom-up
// lcp-interval stack walks (capability equivalent of the reference
// esa-bottomup engine, ref: src/match/esa-bottomup.c:116) and Kasai's LCP
// (ref: src/match/sfx-linlcp.c:31) — run here over device-produced arrays.
//
// Plain C ABI, loaded via ctypes. All buffers are caller-owned numpy
// arrays except the growable outputs, which are malloc'd here and released
// with gt_free().

#include <cstdint>
#include <cstdio>
#include <algorithm>
#include <cstdlib>
#include <cstring>
#include <vector>
#include <thread>
#include <atomic>

extern "C" {

void gt_free(void *p) { free(p); }

// ---------------------------------------------------------------------------
// Kasai 13n LCP construction from keys + suffix array.
// keys: int32[n1] (unique-special suffix keys); sa: int32[n1]; out lcp[n1].
// ---------------------------------------------------------------------------
void gt_kasai_lcp(const int32_t *keys, const int32_t *sa, int64_t n1,
                  int32_t *lcp) {
  std::vector<int64_t> rank(n1);
  for (int64_t i = 0; i < n1; i++) rank[sa[i]] = i;
  int64_t h = 0;
  for (int64_t i = 0; i < n1; i++) {
    int64_t r = rank[i];
    if (r > 0) {
      int64_t j = sa[r - 1];
      while (i + h < n1 && j + h < n1 && keys[i + h] == keys[j + h]) h++;
      lcp[r] = (int32_t)h;
      if (h > 0) h--;
    } else {
      lcp[0] = 0;
      h = 0;
    }
  }
}

// ---------------------------------------------------------------------------
// Bottom-up lcp-interval enumeration (Abouelhoda/Kurtz stack walk,
// ref: src/match/esa-bottomup.c). Emits every lcp-interval with
// depth >= mindepth as (depth, lb, rb) with rb inclusive.
// Returns count; *out_* are malloc'd int32 arrays (free with gt_free).
// ---------------------------------------------------------------------------
int64_t gt_enum_lcp_intervals(const int32_t *lcp, int64_t n1, int32_t mindepth,
                              int32_t **out_depth, int32_t **out_lb,
                              int32_t **out_rb) {
  std::vector<int32_t> vdepth, vlb, vrb;
  struct Itv { int32_t depth; int64_t lb; };
  std::vector<Itv> stack;
  stack.push_back({0, 0});
  for (int64_t i = 1; i <= n1; i++) {
    int32_t l = (i < n1) ? lcp[i] : 0;
    int64_t lb = i - 1;
    while (l < stack.back().depth) {
      Itv top = stack.back();
      stack.pop_back();
      // interval [top.lb, i-1] at depth top.depth
      if (top.depth >= mindepth) {
        vdepth.push_back(top.depth);
        vlb.push_back((int32_t)top.lb);
        vrb.push_back((int32_t)(i - 1));
      }
      lb = top.lb;
    }
    if (l > stack.back().depth) stack.push_back({l, lb});
  }
  int64_t cnt = (int64_t)vdepth.size();
  *out_depth = (int32_t *)malloc(sizeof(int32_t) * (cnt ? cnt : 1));
  *out_lb = (int32_t *)malloc(sizeof(int32_t) * (cnt ? cnt : 1));
  *out_rb = (int32_t *)malloc(sizeof(int32_t) * (cnt ? cnt : 1));
  memcpy(*out_depth, vdepth.data(), sizeof(int32_t) * cnt);
  memcpy(*out_lb, vlb.data(), sizeof(int32_t) * cnt);
  memcpy(*out_rb, vrb.data(), sizeof(int32_t) * cnt);
  return cnt;
}

// ---------------------------------------------------------------------------
// Maximal pairs (repfind core; capability equivalent of
// gt_enumeratemaxpairs_generic, ref: src/match/esa-maxpairs.c:477).
//
// Bottom-up traversal keeping per-interval position lists classified by the
// preceding character (class = code 0..sigma-1, or `sigma` for
// position 0 / preceding special). At each lcp-interval of depth
// >= searchlength, positions arriving from a new child are cross-multiplied
// against positions of *different* classes already in the interval
// (the special class also pairs with itself: each special character is
// unique, so "same class" specials are still left-maximal).
// Right-maximality holds because pairs are only emitted at the interval
// whose depth equals their longest common prefix (children were already
// merged when the pair spans two children).
//
// sa, lcp: int32[n1]; cls: uint8[n1] class per suffix-array entry
// (cls[r] = class of sa[r]); sigma = number of regular classes.
// Outputs malloc'd arrays p1, p2 (positions, p1 from earlier child),
// len (= interval depth). Returns pair count.
// ---------------------------------------------------------------------------
// Invariant of the walk: entering boundary i (the lcp value between ranks
// i-1 and i), the stack top's depth equals lcp[i-1], so leaf i-1 either
// starts a fresh deeper interval (lcp[i] > lcp[i-1]) or attaches to the
// top. Pairs are emitted exactly at the LCA depth: leaf-vs-accumulated on
// attach, completed-child-vs-accumulated on merge. Per-class position
// lists are singly linked for O(1) concatenation (the reference uses the
// same trick, ref: esa-maxpairs.c position lists).
// Stateful streaming variant (Sequentialsuffixarrayreader consumer model,
// ref: src/match/esa-seqread.h:27): the caller feeds (sa, lcp, cls)
// chunks in rank order — lcp[j] is the lcp between the PREVIOUS fed
// entry and entry j (the global .lcp convention) — and memory stays
// bounded by the positions inside currently-open intervals of depth
// >= searchlength: position list cells live in a recycled arena, and
// lists falling into intervals shallower than searchlength are dropped
// (they can never be emitted again: ancestors only get shallower).
struct GtMaxpairsStream {
  int32_t searchlength;
  uint8_t sigma;
  int nclasses;
  std::vector<int32_t> rp1, rp2, rlen;
  // arena linked list of positions: cell = (pos, next); free list recycles
  std::vector<int32_t> apos;
  std::vector<int64_t> anext;
  int64_t freehead = -1;
  struct Node {
    int32_t depth;
    std::vector<int64_t> head, tail;  // per class arena indices; -1 empty
    explicit Node(int32_t d, int nc)
        : depth(d), head(nc, -1), tail(nc, -1) {}
  };
  std::vector<Node> stack;
  int32_t prev_sa = 0;
  uint8_t prev_cls = 0;
  bool has_prev = false;

  GtMaxpairsStream(int32_t sl, uint8_t sg)
      : searchlength(sl), sigma(sg), nclasses(sg + 1) {
    stack.emplace_back(0, nclasses);
  }

  int64_t cell(int32_t pos) {
    if (freehead != -1) {
      int64_t c = freehead;
      freehead = anext[c];
      apos[c] = pos;
      anext[c] = -1;
      return c;
    }
    apos.push_back(pos);
    anext.push_back(-1);
    return (int64_t)apos.size() - 1;
  }
  void drop_list(int64_t head, int64_t tail) {
    if (head == -1) return;
    anext[tail] = freehead;
    freehead = head;
  }
  void emit_vs_node(Node &node, int32_t pos, uint8_t pcls, int32_t depth) {
    if (depth < searchlength) return;
    for (int ca = 0; ca < nclasses; ca++) {
      if (ca == pcls && ca != sigma) continue;  // left-maximality
      for (int64_t r = node.head[ca]; r != -1; r = anext[r]) {
        rp1.push_back(apos[r]);
        rp2.push_back(pos);
        rlen.push_back(depth);
      }
    }
  }
  void emit_child_vs_node(Node &node, Node &child, int32_t depth) {
    if (depth < searchlength) return;
    for (int ca = 0; ca < nclasses; ca++) {
      for (int cb = 0; cb < nclasses; cb++) {
        if (ca == cb && ca != sigma) continue;
        for (int64_t ra = node.head[ca]; ra != -1; ra = anext[ra])
          for (int64_t rb = child.head[cb]; rb != -1; rb = anext[rb]) {
            rp1.push_back(apos[ra]);
            rp2.push_back(apos[rb]);
            rlen.push_back(depth);
          }
      }
    }
  }
  void add_leaf(Node &node, int32_t pos, uint8_t pcls) {
    if (node.depth < searchlength) return;  // never emittable: skip
    int64_t c = cell(pos);
    if (node.head[pcls] == -1) {
      node.head[pcls] = node.tail[pcls] = c;
    } else {
      anext[node.tail[pcls]] = c;
      node.tail[pcls] = c;
    }
  }
  void merge_child(Node &node, Node &child) {
    for (int c = 0; c < nclasses; c++) {
      if (child.head[c] == -1) continue;
      if (node.depth < searchlength) {  // lists die below the threshold
        drop_list(child.head[c], child.tail[c]);
        continue;
      }
      if (node.head[c] == -1) {
        node.head[c] = child.head[c];
        node.tail[c] = child.tail[c];
      } else {
        anext[node.tail[c]] = child.head[c];
        node.tail[c] = child.tail[c];
      }
    }
  }
  void boundary(int32_t l) {
    // leaf = previous entry; l = lcp between it and the next (0 at end)
    if (l > stack.back().depth) {
      Node fresh(l, nclasses);
      add_leaf(fresh, prev_sa, prev_cls);
      stack.push_back(std::move(fresh));
    } else {
      emit_vs_node(stack.back(), prev_sa, prev_cls, stack.back().depth);
      add_leaf(stack.back(), prev_sa, prev_cls);
    }
    while (l < stack.back().depth) {
      Node child = std::move(stack.back());
      stack.pop_back();
      if (l > stack.back().depth) {
        Node fresh(l, nclasses);
        merge_child(fresh, child);  // first child, no emission
        stack.push_back(std::move(fresh));
        break;
      }
      emit_child_vs_node(stack.back(), child, stack.back().depth);
      merge_child(stack.back(), child);
    }
  }
  void feed(const int32_t *sa, const int32_t *lcp, const uint8_t *cls,
            int64_t m) {
    for (int64_t j = 0; j < m; j++) {
      if (has_prev) boundary(lcp[j]);
      prev_sa = sa[j];
      prev_cls = cls[j];
      has_prev = true;
    }
  }
  void finish() {
    if (has_prev) boundary(0);
  }
};

void *gt_maxpairs_stream_new(int32_t searchlength, uint8_t sigma) {
  return new GtMaxpairsStream(searchlength, sigma);
}

void gt_maxpairs_stream_feed(void *h, const int32_t *sa, const int32_t *lcp,
                             const uint8_t *cls, int64_t m) {
  ((GtMaxpairsStream *)h)->feed(sa, lcp, cls, m);
}

int64_t gt_maxpairs_stream_finish(void *h, int32_t **out_p1,
                                  int32_t **out_p2, int32_t **out_len) {
  GtMaxpairsStream *s = (GtMaxpairsStream *)h;
  s->finish();
  int64_t cnt = (int64_t)s->rp1.size();
  *out_p1 = (int32_t *)malloc(sizeof(int32_t) * (cnt ? cnt : 1));
  *out_p2 = (int32_t *)malloc(sizeof(int32_t) * (cnt ? cnt : 1));
  *out_len = (int32_t *)malloc(sizeof(int32_t) * (cnt ? cnt : 1));
  memcpy(*out_p1, s->rp1.data(), sizeof(int32_t) * cnt);
  memcpy(*out_p2, s->rp2.data(), sizeof(int32_t) * cnt);
  memcpy(*out_len, s->rlen.data(), sizeof(int32_t) * cnt);
  delete s;
  return cnt;
}

// chunked variant for the overlapped writer: convert `count` positions
// whose low/hp planes start at a multiple-of-3 global offset into the
// caller's uint64 buffer (no file IO here - the writer thread streams
// the buffer while later chunks are still in flight).
void gt_pack_suf(const uint16_t *low, const uint32_t *hp, int64_t count,
                 uint64_t *out) {
  for (int64_t i = 0; i < count; i++) {
    uint32_t h = (hp[i / 3] >> (10 * (i % 3))) & 1023u;
    out[i] = (uint64_t)low[i] | ((uint64_t)h << 16);
  }
}

// .suf writer for the e2e fast path: combine the split-plane packed
// suffix table (low 16 bits as uint16, three 10-bit highs per uint32)
// into 64-bit words and stream them to disk — one pass, no numpy
// intermediates (index/fastpipe.py write_suf).
int gt_write_suf(const uint16_t *low, const uint32_t *hp, int64_t n1,
                 const char *path) {
  FILE *f = fopen(path, "wb");
  if (!f) return -1;
  const int64_t CH = 1 << 20;
  std::vector<uint64_t> buf((size_t)CH);
  for (int64_t s = 0; s < n1; s += CH) {
    int64_t m = std::min(CH, n1 - s);
    for (int64_t j = 0; j < m; j++) {
      int64_t i = s + j;
      uint32_t h = (hp[i / 3] >> (10 * (i % 3))) & 1023u;
      buf[(size_t)j] = (uint64_t)low[i] | ((uint64_t)h << 16);
    }
    if (fwrite(buf.data(), 8, (size_t)m, f) != (size_t)m) {
      fclose(f);
      return -1;
    }
  }
  fclose(f);
  return 0;
}

int64_t gt_maxpairs(const int32_t *sa, const int32_t *lcp, const uint8_t *cls,
                    int64_t n1, int32_t searchlength, uint8_t sigma,
                    int32_t **out_p1, int32_t **out_p2, int32_t **out_len) {
  GtMaxpairsStream s(searchlength, sigma);
  // whole-array call: lcp[0] is the leading 0 of the .lcp convention,
  // so entry j's boundary lcp is lcp[j] — exactly the feed contract
  s.feed(sa, lcp, cls, n1);
  void *h = new GtMaxpairsStream(std::move(s));
  return gt_maxpairs_stream_finish(h, out_p1, out_p2, out_len);
}

}  // extern "C"

extern "C" {

// 2-bit-plane decode: little-endian u64 words with the first symbol in
// the MSBs -> one uint8 code per symbol (the .esq twobitencoding plane,
// ref: src/core/encseq.c twobitencoding access).  One 256->4-codes LUT
// store per byte, threaded over word ranges.
void gt_twobit_decode(const uint8_t *wordbytes, int64_t nwords,
                      int64_t total, uint8_t *out) {
  static uint32_t lut[256];
  static bool lut_ready = false;
  if (!lut_ready) {
    for (int b = 0; b < 256; b++)
      lut[b] = (uint32_t)((b >> 6) & 3) | ((uint32_t)((b >> 4) & 3) << 8) |
               ((uint32_t)((b >> 2) & 3) << 16) |
               ((uint32_t)(b & 3) << 24);
    lut_ready = true;
  }
  (void)total;
  auto run = [&](int64_t w0, int64_t w1) {
    for (int64_t w = w0; w < w1; w++) {
      const uint8_t *wb = wordbytes + 8 * w;
      uint8_t *o = out + 32 * w;
      for (int t = 0; t < 8; t++) {
        uint32_t v = lut[wb[7 - t]];
        std::memcpy(o + 4 * t, &v, 4);
      }
    }
  };
  unsigned hw = std::thread::hardware_concurrency();
  int T = hw ? (int)hw : 1;
  if (T > 4) T = 4;
  if (nwords < (1 << 18) || T < 2) {
    run(0, nwords);
  } else {
    std::vector<std::thread> th;
    for (int t = 0; t < T; t++)
      th.emplace_back(run, nwords * t / T, nwords * (t + 1) / T);
    for (auto &x : th) x.join();
  }
}

}  // extern "C"

extern "C" {

// Whole-index maxpairs straight off the on-disk tables: u64 suftab +
// capped .lcp bytes + .llv exceptions (rank, value u64 pairs, rank-
// sorted), with the left-context classes derived from the codes
// inline -- one chunked pass feeding the streaming walker, no
// host-side table conversions (ref: gt_enumeratemaxpairs,
// src/match/esa-maxpairs.c:477; special chars >= 254 map to the
// always-left-maximal class).
int64_t gt_maxpairs_esa(const uint8_t *codes, int64_t n,
                        const uint64_t *suf, const uint8_t *lcp_small,
                        const uint64_t *llv, int64_t nllv, int64_t n1,
                        int32_t searchlength, uint8_t sigma,
                        int32_t **out_p1, int32_t **out_p2,
                        int32_t **out_len) {
  (void)n;
  // rank ranges split at lcp < searchlength boundaries are independent
  // interval trees (no pair of depth >= searchlength crosses such a
  // cut), so they walk in parallel; per-range outputs concatenate in
  // rank order == the sequential emission order.
  unsigned hw = std::thread::hardware_concurrency();
  int T = hw ? (int)hw : 1;
  if (T > 4) T = 4;
  std::vector<int64_t> cuts{0};
  if (T >= 2 && n1 > (1 << 21) && searchlength <= 255) {
    for (int t = 1; t < T; t++) {
      int64_t r = n1 * t / T;
      while (r < n1 && lcp_small[r] >= searchlength) r++;
      if (r > cuts.back() && r < n1) cuts.push_back(r);
    }
  }
  cuts.push_back(n1);
  const int R = (int)cuts.size() - 1;
  struct Part {
    int32_t *p1 = nullptr, *p2 = nullptr, *ln = nullptr;
    int64_t cnt = 0;
  };
  std::vector<Part> parts((size_t)R);
  auto run_range = [&](int ri) {
    const int64_t r0 = cuts[(size_t)ri], r1 = cuts[(size_t)ri + 1];
    GtMaxpairsStream s(searchlength, sigma);
    const int64_t CH = 1 << 20;
    std::vector<int32_t> sab((size_t)CH), lcb((size_t)CH);
    std::vector<uint8_t> clb((size_t)CH);
    // llv cursor: first exception at/after r0
    int64_t li = 0, lhi = nllv;
    {
      int64_t lo = 0;
      while (lo < lhi) {
        int64_t mid = (lo + lhi) / 2;
        if ((int64_t)llv[2 * mid] < r0) lo = mid + 1; else lhi = mid;
      }
      li = lo;
    }
    for (int64_t base = r0; base < r1; base += CH) {
      const int64_t m = std::min(CH, r1 - base);
      for (int64_t i = 0; i < m; i++) {
        const uint64_t p = suf[base + i];
        sab[(size_t)i] = (int32_t)p;
        lcb[(size_t)i] = lcp_small[base + i];
        const uint8_t c = (p == 0) ? (uint8_t)254 : codes[p - 1];
        clb[(size_t)i] = c >= 254 ? sigma : c;
      }
      while (li < nllv && (int64_t)llv[2 * li] < base + m) {
        if ((int64_t)llv[2 * li] >= base) {
          const uint64_t v = llv[2 * li + 1];
          lcb[(size_t)((int64_t)llv[2 * li] - base)] =
              (int32_t)(v > 0x7fffffff ? 0x7fffffff : v);
        }
        li++;
      }
      s.feed(sab.data(), lcb.data(), clb.data(), m);
    }
    void *h = new GtMaxpairsStream(std::move(s));
    Part &pt = parts[(size_t)ri];
    pt.cnt = gt_maxpairs_stream_finish(h, &pt.p1, &pt.p2, &pt.ln);
  };
  if (R == 1) {
    run_range(0);
  } else {
    std::vector<std::thread> th;
    for (int ri = 0; ri < R; ri++) th.emplace_back(run_range, ri);
    for (auto &x : th) x.join();
  }
  int64_t total_cnt = 0;
  for (auto &pt : parts) total_cnt += pt.cnt < 0 ? 0 : pt.cnt;
  int32_t *p1 = (int32_t *)malloc(sizeof(int32_t) *
                                  (size_t)(total_cnt ? total_cnt : 1));
  int32_t *p2 = (int32_t *)malloc(sizeof(int32_t) *
                                  (size_t)(total_cnt ? total_cnt : 1));
  int32_t *ln = (int32_t *)malloc(sizeof(int32_t) *
                                  (size_t)(total_cnt ? total_cnt : 1));
  int64_t pos = 0;
  for (auto &pt : parts) {
    if (pt.cnt > 0) {
      std::memcpy(p1 + pos, pt.p1, (size_t)pt.cnt * 4);
      std::memcpy(p2 + pos, pt.p2, (size_t)pt.cnt * 4);
      std::memcpy(ln + pos, pt.ln, (size_t)pt.cnt * 4);
      pos += pt.cnt;
    }
    free(pt.p1);
    free(pt.p2);
    free(pt.ln);
  }
  *out_p1 = p1;
  *out_p2 = p2;
  *out_len = ln;
  return total_cnt;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Xdrop extension -- cost-wave band scan, native twin of ops/xdrop.py
// (behavioral spec: ref src/match/xdrop.c:224, used as spec only; see the
// Python module docstring for the formulation). Batched over (u, v) pairs.
//
// Sequences are uint8 codes; specials (>= 4 in DNA space; anything >= 250)
// never match. Scores fixed to the seed-extend defaults mat=2 mis=-1
// ins=-2 del=-2 => unit edit costs, score quantum 3 (general scores stay
// in Python).
// ---------------------------------------------------------------------------

namespace {

struct XBest {
  int64_t i, j, score;
};

template <int STEP>
static inline int64_t xlcp_t(const uint8_t *u, int64_t ulen,
                             const uint8_t *v, int64_t vlen, int64_t i,
                             int64_t j) {
  int64_t l = 0;
  while (i + l < ulen && j + l < vlen &&
         u[(i + l) * STEP] == v[(j + l) * STEP] && u[(i + l) * STEP] < 4)
    l++;
  return l;
}

static inline int64_t xlcp(const uint8_t *u, int64_t ulen, const uint8_t *v,
                           int64_t vlen, int64_t i, int64_t j) {
  return xlcp_t<1>(u, ulen, v, vlen, i, j);
}

// STEP: read stride (+1 forward, -1 for left flanks read in place)
template <int STEP>
static XBest xdrop_one_t(const uint8_t *u, int64_t ulen, const uint8_t *v,
                         int64_t vlen, int64_t belowscore) {
  XBest peak{0, 0, 0};
  if (ulen == 0 || vlen == 0) return peak;
  // unit edit costs; score(total rows+cols, wave) = total - 3 * wave
  const int64_t quantum = 3, half = 1;
  const int64_t goal_diag = ulen - vlen;
  const int64_t UNSEEN = -(ulen > vlen ? ulen : vlen);
  const int64_t lookback = (belowscore + half) / quantum + 1;

  auto grade = [&](int64_t total, int64_t wv) {
    return total * half - wv * quantum;
  };

  const int64_t run0 = xlcp_t<STEP>(u, ulen, v, vlen, 0, 0);
  peak = {run0, run0, grade(2 * run0, 0)};
  if (run0 >= ulen || run0 >= vlen) return peak;

  // dense reach windows: previous and current wave only (unit costs)
  std::vector<int64_t> peak_log{peak.score};
  std::vector<int64_t> prow{run0}, crow;
  int64_t pbase = 0;
  int64_t lo = 0, hi = 0, w = 0;

  auto at = [&](const std::vector<int64_t> &rows, int64_t base,
                int64_t d) -> int64_t {
    const int64_t ix = d - base;
    return (ix >= 0 && ix < (int64_t)rows.size()) ? rows[ix] : UNSEEN;
  };

  while (lo <= hi) {
    w++;
    const int64_t cbase = lo - 1;
    crow.assign((size_t)(hi - lo + 3), UNSEEN);
    bool moved = false;
    const bool dropping = w - lookback > 0;
    const int64_t floor_sc =
        dropping ? peak_log[(size_t)(w - lookback)] - belowscore : 0;
    for (int64_t d = cbase; d <= hi + 1; d++) {
      // merge the three unit-cost edit sources from the previous wave
      int64_t cand = INT64_MIN / 2;
      bool sourced = false;
      if (d > lo && d - 1 >= -(w - 1) && d - 1 <= w - 1) {  // consume u
        const int64_t c = at(prow, pbase, d - 1) + 1;
        if (c > cand) cand = c;
        sourced = true;
      }
      if (d >= lo && d <= hi && d >= -(w - 1) && d <= w - 1) {  // subst
        const int64_t c = at(prow, pbase, d) + 1;
        if (c > cand) cand = c;
        sourced = true;
      }
      if (d < hi && d + 1 >= -(w - 1) && d + 1 <= w - 1) {  // consume v
        const int64_t c = at(prow, pbase, d + 1);
        if (c > cand) cand = c;
        sourced = true;
      }
      if (!sourced) {  // band edge never fed: the wave still moved
        moved = true;
        continue;
      }
      if (cand < 0) continue;  // unreachable front stays UNSEEN
      int64_t col = cand - d;
      // the drop test: kill fronts that fell more than belowscore under
      // the peak as of `lookback` waves ago
      if (dropping && grade(cand + col, w) < floor_sc) continue;
      moved = true;
      const int64_t prev = at(prow, pbase, d);
      const int64_t cap = ulen < vlen + d ? ulen : vlen + d;
      // a diagonal only advances past the previous wave's front inside
      // both sequences; band-edge diagonals are new and always advance;
      // everyone else carries the old front
      if (d <= -w || d >= w || (prev < cand && cand <= cap)) {
        if (cand < ulen && col < vlen) {  // sprint down the diagonal
          const int64_t r = xlcp_t<STEP>(u, ulen, v, vlen, cand, col);
          cand += r;
          col += r;
        }
        crow[(size_t)(d - cbase)] = cand;
        const int64_t sc = grade(cand + col, w);
        if (sc > peak.score) peak = {cand, col, sc};
      } else {
        crow[(size_t)(d - cbase)] = prev;
      }
    }
    if (!moved) break;  // an all-killed wave ends the extension
    peak_log.push_back(peak.score);
    // complete alignment: u exhausted on the goal diagonal
    if (goal_diag >= -w && goal_diag <= w &&
        at(crow, cbase, goal_diag) == ulen)
      break;
    // shrink the band to the live diagonals ...
    for (int64_t e = cbase; e <= hi + 1; e++)
      if (crow[(size_t)(e - cbase)] > UNSEEN) {
        lo = e;
        break;
      }
    for (int64_t e = hi + 1; e >= cbase; e--)
      if (crow[(size_t)(e - cbase)] > UNSEEN) {
        hi = e;
        break;
      }
    // ... then clip diagonals past a sequence end (innermost first)
    for (int64_t e = 0; e >= lo; e--)
      if (at(crow, cbase, e) == vlen + e) {
        lo = e;
        break;
      }
    for (int64_t e = 0; e <= hi; e++)
      if (at(crow, cbase, e) == ulen) {
        hi = e;
        break;
      }
    prow.swap(crow);
    pbase = cbase;
  }
  return peak;
}

static inline int popcount64(uint64_t v) {
#if defined(__GNUC__)
  return __builtin_popcountll(v);
#else
  int c = 0;
  while (v) { c += v & 1; v >>= 1; }
  return c;
#endif
}

struct GBest {
  int64_t alignedlen, row, distance, max_mismatches, died, touched;
};

// Greedy front-prune extension — native mirror of ops/greedy.py
// (ref: src/match/ft-front-prune.c:633).  STEP is the read stride over
// u and v: +1 for forward flanks, -1 for left flanks read in place from
// the flat code array (u/v then point at the FIRST symbol in reading
// order, i.e. the rightmost) — no window copies.
template <int STEP>
static GBest greedy_one_t(const uint8_t *u, int64_t ulen, const uint8_t *v,
                          int64_t vlen, int64_t max_history,
                          int64_t perc_mat_history,
                          int64_t maxalignedlendifference, int64_t seedlength,
                          const int32_t *pol_diff_from_max,
                          const int32_t *pol_score_sum, int64_t pol_cut_depth,
                          int64_t pol_mask, int trim_enabled) {
  struct FV {
    int64_t row;
    uint64_t hist;
    int64_t hsize;
    int64_t mm;
    bool valid;
  };
  const int64_t sumlen = ulen + vlen;
  const int64_t pol_size = 2 * pol_cut_depth;
  const int64_t minmatch128 =
      (perc_mat_history * 128) / 100 +
      (((perc_mat_history * 128) % 100 == 0) ? 0 : 1);
  const uint64_t hist_mask =
      max_history == 64 ? ~((uint64_t)0) : ((((uint64_t)1) << max_history) - 1);
  GBest best{0, 0, 0, 0, 0, 0};

  auto lcp = [&](int64_t row, int64_t vpos) {
    int64_t l = 0;
    while (row + l < ulen && vpos + l < vlen &&
           u[(row + l) * STEP] == v[(vpos + l) * STEP] &&
           u[(row + l) * STEP] < 4)
      l++;
    return l;
  };
  auto add_matches = [&](FV &fv, int64_t diag) {
    int64_t c = lcp(fv.row, fv.row + diag);
    if (c > 0) {
      if (c >= max_history) {
        fv.hist = ~((uint64_t)0);  // c >= 64 would be UB to shift
      } else {
        fv.hist = (fv.hist << c) | ((((uint64_t)1) << c) - 1);
      }
      if (fv.hsize < max_history) {
        fv.hsize = fv.hsize + c < max_history ? fv.hsize + c : max_history;
      }
      fv.row += c;
    }
  };
  auto shift_diff = [&](FV &fv) {
    if (fv.hsize < max_history) fv.hsize++;
    fv.hist <<= 1;
  };
  auto polished = [&](uint64_t h) {
    uint64_t lo = h & (uint64_t)pol_mask;
    uint64_t hi = (h >> pol_cut_depth) & (uint64_t)pol_mask;
    return pol_diff_from_max[lo] >= 0 &&
           pol_score_sum[lo] + pol_diff_from_max[hi] >= 0;
  };

  // diag-indexed window [lo, hi]; store in vector with offset
  // (thread_local: the fused engine calls this millions of times per
  // segment -- reusing capacity beats a malloc per extension)
  static thread_local std::vector<FV> cur, nxt;
  int64_t lo = 0, hi = 0, base = 0;  // cur[k - base]
  cur.assign(1, FV{0, 0, 0, 0, true});
  if (seedlength >= 64)
    cur[0].hist = ~((uint64_t)0);
  else
    cur[0].hist = ((((uint64_t)1) << seedlength) - 1);
  cur[0].hsize = seedlength < max_history ? seedlength : max_history;
  add_matches(cur[0], 0);
  int64_t distance = 0;

  for (;;) {
    if (distance > 0) {
      nxt.assign((size_t)(hi - lo + 3), FV{0, 0, 0, 0, false});
      int64_t nbase = lo - 1;
      for (int64_t k = lo - 1; k <= hi + 1; k++) {
        FV cand{0, 0, 0, 0, false};
        // INSERTION from prev k-1 (row unchanged)
        if (k - 1 >= lo && k - 1 <= hi && cur[k - 1 - base].valid) {
          cand = cur[k - 1 - base];
          cand.valid = true;
        }
        // MISMATCH from prev k (row+1)
        if (k >= lo && k <= hi && cur[k - base].valid) {
          const FV &c = cur[k - base];
          if (!cand.valid || cand.row < c.row + 1) {
            cand = c;
            cand.row++;
            cand.mm++;
            cand.valid = true;
          } else if (cand.row == c.row + 1) {
            if (cand.mm < c.mm + 1) cand.mm = c.mm + 1;
          }
        }
        // DELETION from prev k+1 (row+1)
        if (k + 1 >= lo && k + 1 <= hi && cur[k + 1 - base].valid) {
          const FV &c = cur[k + 1 - base];
          if (!cand.valid || cand.row < c.row + 1) {
            cand = c;
            cand.row++;
            cand.valid = true;
          }
        }
        if (!cand.valid) continue;
        shift_diff(cand);
        add_matches(cand, k);
        nxt[k - nbase] = cand;
      }
      cur.swap(nxt);
      lo -= 1;
      hi += 1;
      base = lo;
    }

    int64_t maxalignedlen = -1;
    for (int64_t k = lo; k <= hi; k++) {
      if (!cur[k - base].valid) continue;
      int64_t al = 2 * cur[k - base].row + k;
      if (al > maxalignedlen) maxalignedlen = al;
    }

    if (trim_enabled) {
      int64_t minlen = maxalignedlen >= maxalignedlendifference
                           ? maxalignedlen - maxalignedlendifference
                           : 0;
      auto keep = [&](int64_t k) {
        const FV &f = cur[k - base];
        if (!f.valid) return false;
        if (f.row >= ulen || f.row + k >= vlen)
          best.touched = 1;  // live cell at/over the window end: with a
        //                      clipped window the result is unverified
        if (f.row > ulen || f.row + k > vlen) return false;
        if (2 * f.row + k < minlen) return false;
        int64_t need = (f.hsize * minmatch128) >> 7;
        if (popcount64(f.hist & hist_mask) < need) return false;
        return true;
      };
      while (lo <= hi && !keep(lo)) lo++;
      while (hi >= lo && !keep(hi)) hi--;
      if (lo > hi) {
        best.died = 1;  // best polished point keeps its own distance
        return best;
      }
    } else {
      for (int64_t k = lo; k <= hi; k++) {
        FV &f = cur[k - base];
        if (f.valid && (f.row >= ulen || f.row + k >= vlen))
          best.touched = 1;
        if (f.valid && (f.row > ulen || f.row + k > vlen))
          f.valid = false;
      }
      while (lo <= hi && !cur[lo - base].valid) lo++;
      while (hi >= lo && !cur[hi - base].valid) hi--;
      if (lo > hi) {
        best.died = 1;
        return best;
      }
    }

    for (int64_t k = lo; k <= hi; k++) {
      const FV &f = cur[k - base];
      if (!f.valid) continue;
      int64_t al = 2 * f.row + k;
      if (al > best.alignedlen) {
        uint64_t filled = f.hist;
        if (f.hsize < pol_size) {
          int64_t shift = pol_size - f.hsize;
          filled |= ((((uint64_t)1) << shift) - 1) << f.hsize;
        }
        if (polished(filled)) {
          best.alignedlen = al;
          best.row = f.row;
          best.distance = distance;
          best.max_mismatches = f.mm;
        }
      }
    }

    int64_t end_k = vlen - ulen;
    int64_t abs_end = end_k < 0 ? -end_k : end_k;
    if (abs_end <= distance && lo <= end_k && end_k <= hi &&
        cur[end_k - base].valid && cur[end_k - base].row == ulen) {
      return best;
    }
    if (distance >= sumlen) return best;
    distance++;
  }
}

}  // namespace

extern "C" {

// Batched xdrop: n pairs; useqs/vseqs concatenated with offsets.
// out: int64[n*3] = (ivalue, jvalue, score) per pair.
void gt_xdrop_batch(const uint8_t *useq, const int64_t *uoff,
                    const uint8_t *vseq, const int64_t *voff, int64_t n,
                    int64_t belowscore, int64_t *out) {
  for (int64_t p = 0; p < n; p++) {
    XBest b = xdrop_one_t<1>(useq + uoff[2 * p], uoff[2 * p + 1],
                        vseq + voff[2 * p], voff[2 * p + 1], belowscore);
    out[3 * p] = b.i;
    out[3 * p + 1] = b.j;
    out[3 * p + 2] = b.score;
  }
}

// Batched greedy: out int64[n*6] =
// (alignedlen,row,distance,maxmm,died,touched).
void gt_greedy_batch(const uint8_t *useq, const int64_t *uoff,
                     const uint8_t *vseq, const int64_t *voff, int64_t n,
                     int64_t max_history, int64_t perc_mat_history,
                     int64_t maxalignedlendifference,
                     const int64_t *seedlengths,
                     const int32_t *pol_diff_from_max,
                     const int32_t *pol_score_sum, int64_t pol_cut_depth,
                     int64_t pol_mask, int trim_enabled, int64_t *out) {
  for (int64_t p = 0; p < n; p++) {
    GBest b = greedy_one_t<1>(useq + uoff[2 * p], uoff[2 * p + 1],
                         vseq + voff[2 * p], voff[2 * p + 1], max_history,
                         perc_mat_history, maxalignedlendifference,
                         seedlengths[p], pol_diff_from_max, pol_score_sum,
                         pol_cut_depth, pol_mask, trim_enabled);
    out[6 * p] = b.alignedlen;
    out[6 * p + 1] = b.row;
    out[6 * p + 2] = b.distance;
    out[6 * p + 3] = b.max_mismatches;
    out[6 * p + 4] = b.died;
    out[6 * p + 5] = b.touched;
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Fused seed_extend greedy engine (use_apos=0 product path).
//
// One call runs the whole per-strand tail of the seed_extend pipeline over
// the already-joined seed-pair lists: per-(aseq,bseq) segment it applies
// the diagonal-band coverage filter, then the exact sequential
// skip/extend/accept recurrence (capability equivalent of
// gt_diagbandseed_process_seeds + gt_extend_sesp, ref:
// src/match/diagbandseed.c:4136, src/match/seed-extend.c:994), extending
// both flanks IN PLACE over the flat code arrays via the strided greedy
// kernel — no window copies, no per-seed marshalling.  Segments are
// mutually independent and run on a small thread pool; match records are
// emitted in exact segment/seed order.
// ---------------------------------------------------------------------------

namespace {

struct SeedExtRec {
  int64_t dblen, aseq, astart, querylen, bseq, bstart_fwd, score, dist;
  int64_t db_seedpos, query_seedpos, mm, bstart_raw;
};

struct SeedExtCtx {
  const uint8_t *aflat, *bflat;
  const int64_t *a_start, *a_len, *b_start, *b_len;
  const int32_t *pa_seq, *pb_seq, *pb_pos, *pa_pos;
  int64_t k, amaxlen, logw, mincov;
  int use_filter, selfcomp, is_p, max_combine;
  int64_t history, pmh, mad;
  const int32_t *pol_dfm, *pol_ssum;
  int64_t pol_cut, pol_mask;
  int64_t errperc, leastlen2;
  int engine;            // 0 = greedy, 1 = unit-score xdrop
  int64_t belowscore;
};

// per-thread diagband scratch: band-indexed score/lastpos planes plus a
// touched list so clearing costs O(seeds), not O(bands)
struct DiagScratch {
  std::vector<int64_t> score, lastpos;
  std::vector<int64_t> touched;
  void ensure(int64_t cap) {
    if ((int64_t)score.size() < cap) {
      score.assign((size_t)cap, 0);
      lastpos.assign((size_t)cap, 0);
    }
  }
  void clear_touched() {
    for (int64_t d : touched) {
      score[(size_t)d] = 0;
      lastpos[(size_t)d] = 0;
    }
    touched.clear();
  }
};

static void seedext_run_segment(const SeedExtCtx &C, int64_t s0, int64_t s1,
                                DiagScratch &ds,
                                std::vector<SeedExtRec> &out) {
  const int64_t aseq = C.pa_seq[s0], bseq = C.pb_seq[s0];
  const uint8_t *useq = C.aflat + C.a_start[aseq];
  const uint8_t *vseq = C.bflat + C.b_start[bseq];
  const int64_t ulen_t = C.a_len[aseq], vlen_t = C.b_len[bseq];
  const bool same = C.selfcomp && aseq == bseq;
  const int64_t k = C.k;

  if (C.use_filter) {
    int64_t bmax = 0;
    for (int64_t i = s0; i < s1; i++) {
      int64_t band = (C.amaxlen + (int64_t)C.pb_pos[i] -
                      (int64_t)C.pa_pos[i]) >> C.logw;
      if (band > bmax) bmax = band;
    }
    ds.ensure(bmax + 4);
    for (int64_t i = s0; i < s1; i++) {
      int64_t d = ((C.amaxlen + (int64_t)C.pb_pos[i] -
                    (int64_t)C.pa_pos[i]) >> C.logw) + 1;
      int64_t key = C.pb_pos[i];
      if (ds.lastpos[(size_t)d] == 0 || ds.lastpos[(size_t)d] + k <= key) {
        ds.lastpos[(size_t)d] = key;
        ds.score[(size_t)d] += k;
        ds.touched.push_back(d);
      } else if (ds.lastpos[(size_t)d] < key) {
        ds.score[(size_t)d] += key - ds.lastpos[(size_t)d];
        ds.lastpos[(size_t)d] = key;
      }
    }
  }

  bool has_prev = false;
  int64_t T = -1;
  for (int64_t i = s0; i < s1; i++) {
    const int64_t bp = C.pb_pos[i], ap = C.pa_pos[i];
    if (C.use_filter) {
      int64_t band = (C.amaxlen + bp - ap) >> C.logw;
      int64_t cov = ds.score[(size_t)(band + 1)] +
                    std::max(ds.score[(size_t)band],
                             ds.score[(size_t)(band + 2)]);
      if (cov < C.mincov) continue;
    }
    const int64_t db = ap + 1 - k, qs = bp + 1 - k;
    if (same && db + k - 1 >= qs) continue;  // overlapping seed instances
    if (has_prev && T >= bp) continue;       // use_apos=0 skip rule
    int64_t u_l = 0, v_l = 0, sd_l = 0, mm_l = 0;
    if (db > 0 && qs > 0) {
      const int64_t voff = same ? db + k : 0;
      const int64_t ulen = db, vlen = qs - voff;
      if (ulen > 0 && vlen > 0) {
        if (C.engine == 1) {
          XBest x = xdrop_one_t<-1>(useq + db - 1, ulen,
                                    vseq + qs - 1, vlen, C.belowscore);
          u_l = x.i;
          v_l = x.j;
          sd_l = x.score;
        } else {
          GBest g = greedy_one_t<-1>(
              useq + db - 1, ulen, vseq + qs - 1, vlen, C.history,
              C.pmh, C.mad, k, C.pol_dfm, C.pol_ssum, C.pol_cut,
              C.pol_mask, 1);
          u_l = g.row;
          v_l = g.alignedlen - g.row;
          sd_l = g.distance;
          mm_l = g.max_mismatches;
        }
      }
    }
    const int64_t urb = same ? std::min(ulen_t, qs - v_l) : ulen_t;
    int64_t u_r = 0, v_r = 0, sd_r = 0, mm_r = 0;
    if (db + k < urb && qs + k < vlen_t) {
      if (C.engine == 1) {
        XBest x = xdrop_one_t<1>(useq + db + k, urb - db - k,
                                 vseq + qs + k, vlen_t - qs - k,
                                 C.belowscore);
        u_r = x.i;
        v_r = x.j;
        sd_r = x.score;
      } else {
        GBest g = greedy_one_t<1>(
            useq + db + k, urb - db - k, vseq + qs + k, vlen_t - qs - k,
            C.history, C.pmh, C.mad, k, C.pol_dfm,
            C.pol_ssum, C.pol_cut, C.pol_mask, 1);
        u_r = g.row;
        v_r = g.alignedlen - g.row;
        sd_r = g.distance;
        mm_r = g.max_mismatches;
      }
    }
    has_prev = true;
    bool got = false;
    SeedExtRec rec;
    for (int mode = 0; mode <= C.max_combine; mode++) {
      const int64_t ul = mode != 2 ? u_l : 0, vl = mode != 2 ? v_l : 0;
      const int64_t sl = mode != 2 ? sd_l : 0, ml = mode != 2 ? mm_l : 0;
      const int64_t ur = mode != 1 ? u_r : 0, vr = mode != 1 ? v_r : 0;
      const int64_t sr = mode != 1 ? sd_r : 0, mr = mode != 1 ? mm_r : 0;
      const int64_t dblen = k + ul + ur, querylen = k + vl + vr;
      const int64_t alignedlen = dblen + querylen;
      int64_t dist, total_score;
      if (C.engine == 1) {
        // xdrop: sides carry scores; distance derives from the score
        // (ref: seed-extend.c:26 gt_querymatch_score2distance)
        total_score = 2 * k + sl + sr;
        dist = total_score >= 0 ? (alignedlen - total_score) / 3
                                : -((alignedlen + total_score) / 3);
      } else {
        dist = sl + sr;
        total_score = alignedlen - 3 * dist;
      }
      const int64_t astart_ = db - ul, bstart_ = qs - vl;
      if (mode == 0) T = bstart_ + querylen - 1;
      const double err = 200.0 * (double)dist / (double)alignedlen;
      if (err > (double)C.errperc) continue;
      if (alignedlen < C.leastlen2) continue;
      const int64_t bsf =
          C.is_p ? vlen_t - bstart_ - querylen : bstart_;
      rec = SeedExtRec{dblen,    aseq, astart_, querylen, bseq, bsf,
                       total_score, dist, db, qs, ml + mr,
                       bstart_};
      got = true;
      break;
    }
    // selfmatch canonical-orientation rule (ref: querymatch.c:357)
    if (got && C.selfcomp && aseq == bseq) {
      if (C.is_p) {
        if (!(rec.astart < rec.bstart_fwd + 1)) got = false;
      } else if (!(rec.astart < rec.bstart_fwd)) {
        got = false;
      }
    }
    if (got) out.push_back(rec);
  }
  if (C.use_filter) ds.clear_touched();
}

}  // namespace

extern "C" {

// Returns the accepted match count; *out_recs is a malloc'd flat
// int64[12 * count] in segment/seed order (free with gt_free).
int64_t gt_seedext_greedy_run(
    const uint8_t *aflat, const uint8_t *bflat, const int64_t *a_start,
    const int64_t *a_len, const int64_t *b_start, const int64_t *b_len,
    const int32_t *pa_seq, const int32_t *pb_seq, const int32_t *pb_pos,
    const int32_t *pa_pos, int64_t n, int64_t k, int64_t amaxlen,
    int64_t logw, int64_t mincov, int use_filter, int selfcomp, int is_p,
    int max_combine, int64_t history, int64_t pmh, int64_t mad,
    const int32_t *pol_dfm, const int32_t *pol_ssum, int64_t pol_cut,
    int64_t pol_mask, int64_t errperc, int64_t leastlen2,
    int engine, int64_t belowscore,
    int64_t **out_recs) {
  SeedExtCtx C{aflat,  bflat,  a_start, a_len, b_start, b_len,
               pa_seq, pb_seq, pb_pos,  pa_pos, k,      amaxlen,
               logw,   mincov, use_filter, selfcomp, is_p, max_combine,
               history, pmh,   mad,    pol_dfm, pol_ssum, pol_cut,
               pol_mask, errperc, leastlen2, engine, belowscore};
  // segment boundaries: contiguous (aseq, bseq) runs
  std::vector<std::pair<int64_t, int64_t>> segs;
  for (int64_t i = 0; i < n;) {
    int64_t j = i + 1;
    while (j < n && pa_seq[j] == pa_seq[i] && pb_seq[j] == pb_seq[i]) j++;
    segs.emplace_back(i, j);
    i = j;
  }
  unsigned hw = std::thread::hardware_concurrency();
  int nt = (int)std::min<unsigned>(hw ? hw : 1, 8);
  if ((int64_t)segs.size() < 2) nt = 1;
  std::vector<std::vector<SeedExtRec>> outs(segs.size());
  std::atomic<size_t> next{0};
  auto work = [&]() {
    DiagScratch ds;
    for (;;) {
      size_t si = next.fetch_add(1);
      if (si >= segs.size()) break;
      seedext_run_segment(C, segs[si].first, segs[si].second, ds, outs[si]);
    }
  };
  if (nt <= 1) {
    work();
  } else {
    std::vector<std::thread> pool;
    for (int t = 0; t < nt; t++) pool.emplace_back(work);
    for (auto &th : pool) th.join();
  }
  int64_t total = 0;
  for (auto &o : outs) total += (int64_t)o.size();
  int64_t *flat = (int64_t *)malloc(sizeof(int64_t) * 12 *
                                    (size_t)(total ? total : 1));
  int64_t pos = 0;
  for (auto &o : outs)
    for (const SeedExtRec &r : o) {
      flat[pos++] = r.dblen;
      flat[pos++] = r.aseq;
      flat[pos++] = r.astart;
      flat[pos++] = r.querylen;
      flat[pos++] = r.bseq;
      flat[pos++] = r.bstart_fwd;
      flat[pos++] = r.score;
      flat[pos++] = r.dist;
      flat[pos++] = r.db_seedpos;
      flat[pos++] = r.query_seedpos;
      flat[pos++] = r.mm;
      flat[pos++] = r.bstart_raw;
    }
  *out_recs = flat;
  return total;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// SA-IS linear-time suffix-array construction (host oracle).
//
// Capability equivalent of the reference's alternative constructor
// `gt dev sain` (ref: src/match/sfx-sain.c:1577 gt_sain_encseq_sortsuffixes)
// as an independent second path to cross-check the device doubling engine at
// scale. Textbook induced-sorting formulation (Nong/Zhang/Chan 2009),
// written from the published algorithm — not a port of the reference code.
// ---------------------------------------------------------------------------

namespace {

// T[0..n-1] over alphabet [0, K), T[n-1] the unique smallest sentinel.
static void sais_core(const int64_t *T, int64_t *SA, int64_t n, int64_t K) {
  if (n == 1) {
    SA[0] = 0;
    return;
  }
  std::vector<bool> isS(n);
  isS[n - 1] = true;
  for (int64_t i = n - 2; i >= 0; i--)
    isS[i] = T[i] < T[i + 1] || (T[i] == T[i + 1] && isS[i + 1]);
  auto isLMS = [&](int64_t i) { return i > 0 && isS[i] && !isS[i - 1]; };

  std::vector<int64_t> counts(K, 0), bkt(K);
  for (int64_t i = 0; i < n; i++) counts[T[i]]++;
  auto bucketEnds = [&]() {
    int64_t s = 0;
    for (int64_t c = 0; c < K; c++) { s += counts[c]; bkt[c] = s; }
  };
  auto bucketStarts = [&]() {
    int64_t s = 0;
    for (int64_t c = 0; c < K; c++) { bkt[c] = s; s += counts[c]; }
  };

  auto induce = [&]() {
    // L-type left-to-right from bucket starts
    bucketStarts();
    for (int64_t i = 0; i < n; i++) {
      int64_t j = SA[i] - 1;
      if (SA[i] > 0 && !isS[j]) SA[bkt[T[j]]++] = j;
    }
    // S-type right-to-left from bucket ends
    bucketEnds();
    for (int64_t i = n - 1; i >= 0; i--) {
      int64_t j = SA[i] - 1;
      if (SA[i] > 0 && isS[j]) SA[--bkt[T[j]]] = j;
    }
  };

  // step 1: place LMS suffixes at their bucket ends, induce once
  std::fill(SA, SA + n, -1);
  bucketEnds();
  for (int64_t i = n - 1; i >= 0; i--)
    if (isLMS(i)) SA[--bkt[T[i]]] = i;
  // guard: induce skips SA[i] <= 0 via the SA[i] > 0 test; -1 entries are
  // only ever read, never dereferenced into T
  {
    // replace -1 with 0 sentinel-safe handling: induced sort only reads
    // SA[i] - 1 when SA[i] > 0, so -1 entries are inert
  }
  induce();

  // step 2: name LMS substrings in SA order
  int64_t nlms = 0;
  for (int64_t i = 0; i < n; i++)
    if (isLMS(SA[i])) SA[nlms++] = SA[i];
  std::fill(SA + nlms, SA + n, -1);
  int64_t *names = SA + nlms;
  int64_t name = 0, prev = -1;
  for (int64_t i = 0; i < nlms; i++) {
    int64_t pos = SA[i];
    bool diff = false;
    if (prev < 0) {
      diff = true;
    } else {
      for (int64_t d = 0;; d++) {
        if (T[pos + d] != T[prev + d] || isS[pos + d] != isS[prev + d]) {
          diff = true;
          break;
        }
        if (d > 0 && (isLMS(pos + d) || isLMS(prev + d))) {
          diff = isLMS(pos + d) != isLMS(prev + d);
          break;
        }
      }
    }
    if (diff) { name++; prev = pos; }
    names[pos / 2] = name - 1;
  }
  // compact names in text order
  std::vector<int64_t> s1(nlms);
  {
    int64_t k = 0;
    for (int64_t i = nlms; i < n; i++)
      if (SA[i] >= 0) s1[k++] = SA[i];
  }

  // step 3: sort the reduced problem
  std::vector<int64_t> sa1(nlms);
  if (name < nlms) {
    sais_core(s1.data(), sa1.data(), nlms, name);
  } else {
    for (int64_t i = 0; i < nlms; i++) sa1[s1[i]] = i;
  }

  // step 4: place LMS suffixes by sa1 order, induce final
  std::vector<int64_t> lmspos;
  lmspos.reserve(nlms);
  for (int64_t i = 0; i < n; i++)
    if (isLMS(i)) lmspos.push_back(i);
  std::fill(SA, SA + n, -1);
  bucketEnds();
  for (int64_t i = nlms - 1; i >= 0; i--) {
    int64_t j = lmspos[sa1[i]];
    SA[--bkt[T[j]]] = j;
  }
  induce();
}

}  // namespace

extern "C" {

// keys: int32[n] (unique-special suffix keys, see Encseq.suffix_keys —
// may contain any non-negative values). Writes sa_out[0..n-1].
void gt_sais(const int32_t *keys, int64_t n, int32_t *sa_out) {
  if (n <= 0) return;
  // shift +1 and append the unique smallest sentinel 0
  std::vector<int64_t> T(n + 1);
  int64_t K = 0;
  for (int64_t i = 0; i < n; i++) {
    T[i] = (int64_t)keys[i] + 1;
    if (T[i] + 1 > K) K = T[i] + 1;
  }
  T[n] = 0;
  std::vector<int64_t> SA(n + 1);
  sais_core(T.data(), SA.data(), n + 1, K);
  for (int64_t i = 1; i <= n; i++) sa_out[i - 1] = (int32_t)SA[i];
}

}  // extern "C"

extern "C" {

// Fill fixed-width task windows for the device extension batch:
// out[t*W .. t*W+W) = flat[off[sel[t]] .. +len] padded with `fill`.
// (The numpy fancy-gather formulation is memory-bound-pathological on
// small VMs; this is a straight memcpy per lane.)
void gt_fill_windows(const uint8_t *flat, const int64_t *off,
                     const int64_t *lens, const int64_t *sel,
                     int64_t nsel, int64_t W, uint8_t fill,
                     uint8_t *out) {
  for (int64_t t = 0; t < nsel; t++) {
    const int64_t i = sel[t];
    const int64_t l = lens[i] < W ? lens[i] : W;
    uint8_t *dst = out + t * W;
    std::memcpy(dst, flat + off[i], (size_t)l);
    std::memset(dst + l, fill, (size_t)(W - l));
  }
}

}  // extern "C"

extern "C" {

// Tallymer mkindex core: one linear pass over the ESA (the vectorized
// segmentation of tyr-mkindex, see match/tallymer.py docstring —
// ref: src/match/tyr-mkindex.c:514 enumeratelcpintervals).  Runs of
// ranks with lcp >= k share one mer; a run is valid iff its first
// suffix has k regular characters (later members inherit validity:
// lcp counts only regular matches).  Emits 2-bit MSB-packed mers in
// suffix (= lexicographic) order plus uint32 counts.
// lcp is the small-lcp byte table; k must be <= 255 (255 means >= 255
// >= k, so the byte compare is exact for every k <= 255).
static int64_t tallymer_scan(const uint8_t *codes, int64_t n,
                             const uint64_t *sa, const uint8_t *lcp,
                             int64_t rlo, int64_t rhi, int64_t n1,
                             int64_t k, int64_t minocc, int64_t maxocc,
                             uint8_t *out_mers, uint32_t *out_counts,
                             uint8_t *out_small) {
  const int64_t merbytes = (k + 3) / 4;
  int64_t nmers = 0;
  int64_t run_count = 0;
  int64_t run_first = -1;  // start position of the run's mer, -1 invalid
  for (int64_t r = rlo; r <= rhi; r++) {
    if (r == rhi || lcp[r] < k) {
      if (run_first >= 0 && run_count >= minocc &&
          (maxocc < 0 || run_count <= maxocc)) {
        uint8_t *dst = out_mers + nmers * merbytes;
        const uint8_t *src = codes + run_first;
        int64_t i = 0;
        for (int64_t b = 0; b < merbytes; b++) {
          uint8_t v = 0;
          for (int s = 6; s >= 0; s -= 2) {
            v |= (uint8_t)((i < k ? (src[i] & 3) : 0) << s);
            i++;
          }
          dst[b] = v;
        }
        out_counts[nmers] = (uint32_t)run_count;
        out_small[nmers] =
            run_count > 255 ? (uint8_t)255 : (uint8_t)run_count;
        nmers++;
      }
      run_count = 0;
      run_first = -1;
      if (r == rhi) break;
      const int64_t p = (int64_t)sa[r];
      if (p + k <= n) {
        bool ok = true;
        for (int64_t j = 0; j < k; j++)
          if (codes[p + j] >= 4) { ok = false; break; }
        if (ok) { run_first = p; run_count = 1; }
      }
    } else if (run_first >= 0) {
      run_count++;
    }
  }
  return nmers;
}

void gt_tallymer_mkindex(const uint8_t *codes, int64_t n,
                         const uint64_t *sa, const uint8_t *lcp,
                         int64_t n1, int64_t k, int64_t minocc,
                         int64_t maxocc, uint8_t *out_mers,
                         uint32_t *out_counts, uint8_t *out_small,
                         int64_t *out_nmers) {
  const int64_t merbytes = (k + 3) / 4;
  unsigned hw = std::thread::hardware_concurrency();
  int64_t T = hw ? (int64_t)hw : 2;
  if (T > 8) T = 8;
  if (n1 < (int64_t)1 << 20 || T < 2) {
    *out_nmers = tallymer_scan(codes, n, sa, lcp, 0, n1, n1, k, minocc,
                               maxocc, out_mers, out_counts, out_small);
    return;
  }
  // split the rank range at run boundaries (lcp[r] < k); each worker
  // emits into its own slice of the (worst-case-sized) output buffers,
  // then slices are compacted in order — emission order is preserved
  std::vector<int64_t> starts(T + 1, n1);
  starts[0] = 0;
  for (int64_t t = 1; t < T; t++) {
    int64_t r = t * (n1 / T);
    while (r < n1 && lcp[r] >= k) r++;
    starts[t] = r;
  }
  std::vector<int64_t> cnt(T, 0);
  std::vector<std::thread> th;
  for (int64_t t = 0; t < T; t++) {
    th.emplace_back([&, t]() {
      cnt[t] = tallymer_scan(codes, n, sa, lcp, starts[t], starts[t + 1],
                             n1, k, minocc, maxocc,
                             out_mers + starts[t] * merbytes,
                             out_counts + starts[t],
                             out_small + starts[t]);
    });
  }
  for (auto &x : th) x.join();
  int64_t nmers = cnt[0];
  for (int64_t t = 1; t < T; t++) {
    std::memmove(out_mers + nmers * merbytes,
                 out_mers + starts[t] * merbytes,
                 (size_t)(cnt[t] * merbytes));
    std::memmove(out_counts + nmers, out_counts + starts[t],
                 (size_t)(cnt[t] * 4));
    std::memmove(out_small + nmers, out_small + starts[t],
                 (size_t)cnt[t]);
    nmers += cnt[t];
  }
  *out_nmers = nmers;
}

}  // extern "C"

namespace seedjoin {
void radix_u64(std::vector<uint64_t> &v, int nbits);
void radix_u64_mt(std::vector<uint64_t> &v, int nbits, int nthreads);
void radix_u64_mt_range(std::vector<uint64_t> &v, int lo_bit,
                        int hi_bit, int nthreads);
}  // namespace seedjoin

extern "C" {

// ESA-free tallymer counting: enumerate the valid k-windows over the
// per-sequence spans, parallel-radix-sort the 2-bit codes, run-length
// emit — sorted-code order equals the ESA walk's emission order, so
// the .mer/.mct bytes are identical while skipping the .suf/.lcp load
// entirely (capability of tyr-mkindex counting, ref:
// src/match/tyr-mkindex.c).  k <= 31; returns the mer count.
int64_t gt_tallymer_count(const uint8_t *flat, const int64_t *seq_start,
                          const int64_t *seq_len, int64_t nseq, int64_t k,
                          int64_t minocc, int64_t maxocc, int nthreads,
                          uint8_t *out_mers, uint32_t *out_counts,
                          uint8_t *out_small) {
  if (k > 31) return -2;
  const int64_t merbytes = (k + 3) / 4;
  const uint64_t mask = ((uint64_t)1 << (2 * k)) - 1;
  // threaded two-pass enumeration (count, then emit at prefix
  // offsets) -- same chunking as gt_kmer_list
  struct Chunk {
    int64_t s, i0, i1, cnt, off;
  };
  std::vector<Chunk> chunks;
  {
    int T = nthreads < 1 ? 1 : (nthreads > 8 ? 8 : nthreads);
    for (int64_t s = 0; s < nseq; s++) {
      const int64_t len = seq_len[s];
      if (len < k) continue;
      const int64_t w0 = k - 1, span = len - w0;
      const int nch = (span > (1 << 20)) ? T : 1;
      for (int c = 0; c < nch; c++)
        chunks.push_back({s, w0 + span * c / nch,
                          w0 + span * (c + 1) / nch, 0, 0});
    }
  }
  std::vector<uint64_t> v;
  auto scan = [&](Chunk &ch, bool emit) {
    const uint8_t *p = flat + seq_start[ch.s];
    uint64_t code = 0;
    int64_t bad = -1;
    const int64_t warm = ch.i0 - (k - 1);
    for (int64_t i = warm < 0 ? 0 : warm; i < ch.i0; i++) {
      const uint8_t c = p[i];
      if (c >= 4) bad = i;
      code = ((code << 2) | (c >= 4 ? 0 : c)) & mask;
    }
    int64_t w = ch.off;
    for (int64_t i = ch.i0; i < ch.i1; i++) {
      const uint8_t c = p[i];
      if (c >= 4) {
        bad = i;
        code = (code << 2) & mask;
      } else {
        code = ((code << 2) | c) & mask;
      }
      if (bad <= i - k) {
        if (emit) v[(size_t)w] = code;
        w++;
      }
    }
    ch.cnt = w - ch.off;
  };
  auto phase = [&](bool emit) {
    int T = nthreads < 1 ? 1 : (nthreads > 8 ? 8 : nthreads);
    if ((int64_t)chunks.size() <= 1 || T < 2) {
      for (auto &ch : chunks) scan(ch, emit);
      return;
    }
    std::atomic<size_t> next{0};
    std::vector<std::thread> th;
    for (int t = 0; t < T; t++)
      th.emplace_back([&]() {
        for (;;) {
          size_t i = next.fetch_add(1);
          if (i >= chunks.size()) break;
          scan(chunks[i], emit);
        }
      });
    for (auto &x : th) x.join();
  };
  phase(false);
  int64_t total_w = 0;
  for (auto &ch : chunks) {
    ch.off = total_w;
    total_w += ch.cnt;
  }
  v.resize((size_t)total_w);
  phase(true);
  seedjoin::radix_u64_mt(v, (int)(2 * k), nthreads);
  const int shift_pad = (int)((merbytes * 4 - k) * 2);
  int64_t nm = 0;
  const size_t n = v.size();
  for (size_t i = 0; i < n;) {
    size_t j = i + 1;
    while (j < n && v[j] == v[i]) j++;
    const int64_t c = (int64_t)(j - i);
    if (c >= minocc && (maxocc < 0 || c <= maxocc)) {
      const uint64_t full = v[i] << shift_pad;
      uint8_t *dst = out_mers + nm * merbytes;
      for (int64_t b = 0; b < merbytes; b++)
        dst[b] = (uint8_t)(full >> ((merbytes - 1 - b) * 8));
      out_counts[nm] = (uint32_t)c;
      out_small[nm] = c > 255 ? (uint8_t)255 : (uint8_t)c;
      nm++;
    }
    i = j;
  }
  return nm;
}

}  // extern "C"

extern "C" {

// Bulk tallymer-search line emission: "qseqnum\t<strand>qpos\tcounts"
// rows (with_seqnum=0 drops the first column) — mirrors the per-row
// formatting of `gt tallymer search -output`.
int gt_tyr_write_lines(const int64_t *qs, const int64_t *qp,
                       const int64_t *ct, const uint8_t *st, int64_t n,
                       const char *path, int with_seqnum, int append) {
  FILE *fp = fopen(path, append ? "ab" : "wb");
  if (!fp) return -1;
  std::vector<char> buf(1 << 20);
  char *p = buf.data();
  char *end = buf.data() + buf.size() - 128;
  for (int64_t i = 0; i < n; i++) {
    if (with_seqnum)
      p += snprintf(p, 100, "%lld\t%c%lld\t%lld\n", (long long)qs[i],
                    (char)st[i], (long long)qp[i], (long long)ct[i]);
    else
      p += snprintf(p, 100, "%c%lld\t%lld\n", (char)st[i],
                    (long long)qp[i], (long long)ct[i]);
    if (p >= end) {
      fwrite(buf.data(), 1, (size_t)(p - buf.data()), fp);
      p = buf.data();
    }
  }
  if (p > buf.data()) fwrite(buf.data(), 1, (size_t)(p - buf.data()), fp);
  fclose(fp);
  return 0;
}

}  // extern "C"

extern "C" {

// Bulk match-line formatter: rows of (len, seq1, rel1, len2, seq2,
// rel2) printed as "len seq1 rel1 <dir> len2 seq2 rel2\n" — the
// repfind output record (ref: src/match/querymatch.c display) written
// with a local itoa instead of per-line Python formatting.
static inline char *put_u64(char *p, unsigned long long v) {
  char tmp[24];
  int i = 0;
  if (v == 0) tmp[i++] = '0';
  while (v) { tmp[i++] = (char)('0' + v % 10); v /= 10; }
  while (i) *p++ = tmp[--i];
  return p;
}

int gt_write_match_lines(const int64_t *rows, int64_t n, char dir,
                         const char *path, int append) {
  FILE *fp = fopen(path, append ? "ab" : "wb");
  if (!fp) return -1;
  std::vector<char> buf(1 << 20);
  char *p = buf.data();
  char *end = buf.data() + buf.size() - 160;
  for (int64_t r = 0; r < n; r++) {
    const int64_t *q = rows + 6 * r;
    p = put_u64(p, (unsigned long long)q[0]); *p++ = ' ';
    p = put_u64(p, (unsigned long long)q[1]); *p++ = ' ';
    p = put_u64(p, (unsigned long long)q[2]); *p++ = ' ';
    *p++ = dir; *p++ = ' ';
    p = put_u64(p, (unsigned long long)q[3]); *p++ = ' ';
    p = put_u64(p, (unsigned long long)q[4]); *p++ = ' ';
    p = put_u64(p, (unsigned long long)q[5]); *p++ = '\n';
    if (p >= end) {
      fwrite(buf.data(), 1, (size_t)(p - buf.data()), fp);
      p = buf.data();
    }
  }
  if (p > buf.data()) fwrite(buf.data(), 1, (size_t)(p - buf.data()), fp);
  fclose(fp);
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Seed-extend k-mer enumeration + bulk match-line emission.
// ---------------------------------------------------------------------------

extern "C" {

// Enumerate all valid k-windows over the per-sequence spans of a flat
// code array (capability of gt_diagbandseed_get_kmers, ref:
// src/match/diagbandseed.c:1189): windows containing a special code
// (>= 4) are dropped.  Outputs are parallel (code int64, seq int32,
// endpos int32) arrays, endpos relative to its sequence start, in span
// reading order.  Returns the entry count (caller sized the outputs to
// sum(len - k + 1)).
int64_t gt_kmer_list(const uint8_t *flat, const int64_t *seq_start,
                     const int64_t *seq_len, int64_t nseq, int64_t k,
                     int64_t *out_code, int32_t *out_seq,
                     int32_t *out_pos) {
  const int64_t mask = (k >= 32) ? -1 : ((int64_t)1 << (2 * k)) - 1;
  // chunk plan: split every sequence's window-end range over threads;
  // each chunk re-rolls its first k-1 symbols, counts its valid
  // windows (pass 1), then emits at its exclusive-prefix offset
  // (pass 2) -- output order identical to the serial scan
  struct Chunk {
    int64_t s, i0, i1;  // sequence, window-end range [i0, i1)
    int64_t cnt, off;
  };
  std::vector<Chunk> chunks;
  unsigned hw = std::thread::hardware_concurrency();
  int T = hw ? (int)hw : 1;
  if (T > 8) T = 8;
  for (int64_t s = 0; s < nseq; s++) {
    const int64_t len = seq_len[s];
    if (len < k) continue;
    const int64_t w0 = k - 1, w1 = len;
    const int64_t span = w1 - w0;
    const int nch = (span > (1 << 20)) ? T : 1;
    for (int c = 0; c < nch; c++)
      chunks.push_back({s, w0 + span * c / nch, w0 + span * (c + 1) / nch,
                        0, 0});
  }
  auto scan = [&](Chunk &ch, bool emit) {
    const uint8_t *p = flat + seq_start[ch.s];
    int64_t code = 0;
    int64_t bad = -1;
    const int64_t warm = ch.i0 - (k - 1);
    for (int64_t i = warm < 0 ? 0 : warm; i < ch.i0; i++) {
      const uint8_t c = p[i];
      if (c >= 4) bad = i;
      code = ((code << 2) | (c >= 4 ? 0 : c)) & mask;
    }
    int64_t w = ch.off;
    for (int64_t i = ch.i0; i < ch.i1; i++) {
      const uint8_t c = p[i];
      if (c >= 4) {
        bad = i;
        code = (code << 2) & mask;
      } else {
        code = ((code << 2) | c) & mask;
      }
      if (bad <= i - k) {
        if (emit) {
          out_code[w] = code;
          out_seq[w] = (int32_t)ch.s;
          out_pos[w] = (int32_t)i;
        }
        w++;
      }
    }
    ch.cnt = w - ch.off;
  };
  auto run_phase = [&](bool emit) {
    if ((int64_t)chunks.size() <= 1 || T < 2) {
      for (auto &ch : chunks) scan(ch, emit);
      return;
    }
    std::atomic<size_t> next{0};
    std::vector<std::thread> th;
    for (int t = 0; t < T; t++)
      th.emplace_back([&]() {
        for (;;) {
          size_t i = next.fetch_add(1);
          if (i >= chunks.size()) break;
          scan(chunks[i], emit);
        }
      });
    for (auto &x : th) x.join();
  };
  run_phase(false);
  int64_t total = 0;
  for (auto &ch : chunks) {
    ch.off = total;
    total += ch.cnt;
  }
  run_phase(true);
  return total;
}

// Bulk seed_extend match-line emission: recs are the 12-column
// gt_seedext_greedy_run records; line format mirrors
// SeedExtendMatch.line().
int gt_seedext_write_lines(const int64_t *recs, int64_t n, char dir,
                           const char *path, int append) {
  FILE *fp = fopen(path, append ? "ab" : "wb");
  if (!fp) return -1;
  std::vector<char> buf(1 << 20);
  char *p = buf.data();
  char *end = buf.data() + buf.size() - 256;
  for (int64_t r = 0; r < n; r++) {
    const int64_t *q = recs + 12 * r;
    const double ident =
        100.0 - 200.0 * (double)q[7] / (double)(q[0] + q[3]);
    p += snprintf(p, 200,
                  "%lld %lld %lld %c %lld %lld %lld %lld %lld %.2f\n",
                  (long long)q[0], (long long)q[1], (long long)q[2], dir,
                  (long long)q[3], (long long)q[4], (long long)q[5],
                  (long long)q[6], (long long)q[7], ident);
    if (p >= end) {
      fwrite(buf.data(), 1, (size_t)(p - buf.data()), fp);
      p = buf.data();
    }
  }
  if (p > buf.data()) fwrite(buf.data(), 1, (size_t)(p - buf.data()), fp);
  fclose(fp);
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Seed-pair join: the gt_diagbandseed_merge capability
// (ref: src/match/diagbandseed.c:2654 seed-pair merge of two sorted
// k-mer lists, with maxfreq capping and the self-comparison rules).
//
// Inputs are the raw (code, seqnum, endpos) k-mer lists in strand
// reading order; the join radix-sorts (code, index) packs, walks the
// matched code groups once, applies the selfcomp / same-sequence
// distance window / maxfreq rules inline at emission, packs surviving
// pairs as (aseq, bseq, bpos, apos) bit fields in one uint64, radix
// sorts those, and unpacks — so the output order is exactly the
// numpy engine's lexsort order at a fraction of its cost (no
// comparison sorts, no boolean temp planes).  Returns -2 when the bit
// budget does not fit 64 (caller falls back to numpy).
// ---------------------------------------------------------------------------

namespace seedjoin {

static inline int bits_for(uint64_t maxval) {
  int b = 0;
  while ((maxval >> b) != 0) b++;
  return b < 1 ? 1 : b;
}

// LSD radix sort, 16-bit digits, low `nbits` significant.
void radix_u64(std::vector<uint64_t> &v, int nbits) {
  const size_t n = v.size();
  if (n < 2) return;
  std::vector<uint64_t> tmp(n);
  std::vector<size_t> cnt(1 << 16);
  uint64_t *src = v.data(), *dst = tmp.data();
  int passes = (nbits + 15) / 16;
  for (int p = 0; p < passes; p++) {
    const int shift = p * 16;
    std::fill(cnt.begin(), cnt.end(), 0);
    for (size_t i = 0; i < n; i++) cnt[(src[i] >> shift) & 0xFFFF]++;
    size_t sum = 0;
    for (size_t d = 0; d < (1u << 16); d++) {
      size_t c = cnt[d]; cnt[d] = sum; sum += c;
    }
    for (size_t i = 0; i < n; i++)
      dst[cnt[(src[i] >> shift) & 0xFFFF]++] = src[i];
    std::swap(src, dst);
  }
  if (src != v.data()) std::memcpy(v.data(), src, n * sizeof(uint64_t));
}

// parallel LSD radix: per-thread digit histograms, one (digit, thread)
// prefix, then each thread scatters its own contiguous slice with its
// base offsets -- stable, same order as the serial sort.
void radix_u64_mt(std::vector<uint64_t> &v, int nbits,
                         int nthreads) {
  const size_t n = v.size();
  if (n < (1u << 17) || nthreads < 2) return radix_u64(v, nbits);
  radix_u64_mt_range(v, 0, nbits, nthreads);
}

// Stable LSD radix over bit range [lo_bit, hi_bit) only: when the low
// bits are a pre-ordered tiebreak (e.g. the input index embedded below
// a sort key), stability makes sorting just the key bits equivalent to
// sorting the whole word -- at half the passes.
void radix_u64_mt_range(std::vector<uint64_t> &v, int lo_bit,
                        int hi_bit, int nthreads) {
  const size_t n = v.size();
  const int T = nthreads > 8 ? 8 : nthreads;
  std::vector<uint64_t> tmp(n);
  uint64_t *src = v.data(), *dst = tmp.data();
  const int passes = (hi_bit - lo_bit + 15) / 16;
  std::vector<std::vector<size_t>> cnt((size_t)T,
                                       std::vector<size_t>(1 << 16));
  std::vector<size_t> bounds((size_t)T + 1);
  for (int t = 0; t <= T; t++) bounds[(size_t)t] = n * (size_t)t / (size_t)T;
  for (int p = 0; p < passes; p++) {
    const int shift = lo_bit + p * 16;
    {
      std::vector<std::thread> th;
      for (int t = 0; t < T; t++)
        th.emplace_back([&, t]() {
          auto &c = cnt[(size_t)t];
          std::fill(c.begin(), c.end(), 0);
          for (size_t i = bounds[(size_t)t]; i < bounds[(size_t)t + 1]; i++)
            c[(src[i] >> shift) & 0xFFFF]++;
        });
      for (auto &x : th) x.join();
    }
    size_t sum = 0;
    for (size_t d = 0; d < (1u << 16); d++)
      for (int t = 0; t < T; t++) {
        size_t c = cnt[(size_t)t][d];
        cnt[(size_t)t][d] = sum;
        sum += c;
      }
    {
      std::vector<std::thread> th;
      for (int t = 0; t < T; t++)
        th.emplace_back([&, t]() {
          auto &c = cnt[(size_t)t];
          for (size_t i = bounds[(size_t)t]; i < bounds[(size_t)t + 1]; i++)
            dst[c[(src[i] >> shift) & 0xFFFF]++] = src[i];
        });
      for (auto &x : th) x.join();
    }
    std::swap(src, dst);
  }
  if (src != v.data()) std::memcpy(v.data(), src, n * sizeof(uint64_t));
}

}  // namespace seedjoin

extern "C" {

// Returns the pair count (>= 0) with *out_* set to malloc'd int32
// planes (caller frees via gt_free), or -2 if the inputs exceed the
// packed 64-bit budget (caller falls back).
// a_sorted/out_a_sorted: optional reuse of the sorted a-list pack
// across calls sharing the SAME a list and bit budget (fixed by
// force_cb/force_iab > 0); out_a_sorted, when non-null, receives a
// malloc'd copy of the pack (caller frees via gt_free).
int64_t gt_seed_pair_join2(
    const int64_t *acode, const int32_t *aseq, const int32_t *apos,
    int64_t na,
    const int64_t *bcode, const int32_t *bseq, const int32_t *bpos,
    int64_t nb,
    int same_list, int selfcomp, int inseqseeds,
    int64_t maxfreq, int64_t mindist, int64_t maxdist, int nthreads,
    int force_cb, int force_iab, const uint64_t *a_sorted,
    uint64_t **out_a_sorted,
    int32_t **out_aseq, int32_t **out_bseq, int32_t **out_bpos,
    int32_t **out_apos) {
  using seedjoin::bits_for;
  using seedjoin::radix_u64_mt;
  using seedjoin::radix_u64_mt_range;
  if (na <= 0 || nb <= 0) {
    *out_aseq = *out_bseq = *out_bpos = *out_apos = nullptr;
    return 0;
  }
  // bit budgets
  int64_t maxac = 0, maxbc = 0;
  int32_t max_as = 0, max_ap = 0, max_bs = 0, max_bp = 0;
  for (int64_t i = 0; i < na; i++) {
    if (acode[i] > maxac) maxac = acode[i];
    if (aseq[i] > max_as) max_as = aseq[i];
    if (apos[i] > max_ap) max_ap = apos[i];
  }
  if (same_list) {
    maxbc = maxac; max_bs = max_as; max_bp = max_ap;
  } else {
    for (int64_t i = 0; i < nb; i++) {
      if (bcode[i] > maxbc) maxbc = bcode[i];
      if (bseq[i] > max_bs) max_bs = bseq[i];
      if (bpos[i] > max_bp) max_bp = bpos[i];
    }
  }
  const int cb = force_cb > 0 ? force_cb
      : bits_for((uint64_t)(maxac > maxbc ? maxac : maxbc));
  const int iab = force_iab > 0 ? force_iab
      : bits_for((uint64_t)(na > nb ? na : nb));
  if (force_cb > 0 &&
      (uint64_t)(maxac > maxbc ? maxac : maxbc) >> force_cb)
    return -2;
  if (force_iab > 0 && (uint64_t)(na > nb ? na : nb) >> force_iab)
    return -2;
  const int f_as = bits_for((uint64_t)max_as);
  const int f_bs = bits_for((uint64_t)max_bs);
  const int f_bp = bits_for((uint64_t)max_bp);
  const int f_ap = bits_for((uint64_t)max_ap);
  if (cb + iab > 64 || f_as + f_bs + f_bp + f_ap > 64) return -2;

  // sort (code, idx) packs per list; the a pack can arrive presorted
  std::vector<uint64_t> sa(na);
  if (a_sorted != nullptr) {
    std::memcpy(sa.data(), a_sorted, (size_t)na * 8);
  } else {
    for (int64_t i = 0; i < na; i++)
      sa[i] = ((uint64_t)acode[i] << iab) | (uint64_t)i;
    // the embedded index below the code IS ascending input order:
    // stable radix over the code bits alone reproduces the full sort
    radix_u64_mt_range(sa, iab, cb + iab, nthreads);
  }
  if (out_a_sorted != nullptr) {
    uint64_t *cp = (uint64_t *)malloc((size_t)na * 8);
    std::memcpy(cp, sa.data(), (size_t)na * 8);
    *out_a_sorted = cp;
  }
  std::vector<uint64_t> sb_store;
  const std::vector<uint64_t> *sb = &sa;
  if (!same_list) {
    sb_store.resize(nb);
    for (int64_t i = 0; i < nb; i++)
      sb_store[i] = ((uint64_t)bcode[i] << iab) | (uint64_t)i;
    radix_u64_mt_range(sb_store, iab, cb + iab, nthreads);
    sb = &sb_store;
  }
  const uint64_t idxmask = (iab >= 64) ? ~0ull : ((1ull << iab) - 1);

  // group boundaries per list (starts of equal-code runs)
  auto group_starts = [&](const std::vector<uint64_t> &s,
                          std::vector<int64_t> &g) {
    const int64_t n = (int64_t)s.size();
    g.clear();
    for (int64_t i = 0; i < n; i++)
      if (i == 0 || (s[i] >> iab) != (s[i - 1] >> iab)) g.push_back(i);
    g.push_back(n);
  };
  std::vector<int64_t> ga, gb_store;
  group_starts(sa, ga);
  const std::vector<int64_t> *gb = &ga;
  if (!same_list) { group_starts(*sb, gb_store); gb = &gb_store; }

  // matched (a-group, b-group) list
  struct GP { int64_t a0, a1, b0, b1; };
  std::vector<GP> gps;
  {
    const int64_t nga = (int64_t)ga.size() - 1;
    const int64_t ngb = (int64_t)gb->size() - 1;
    int64_t j = 0;
    for (int64_t i = 0; i < nga; i++) {
      const uint64_t ca = sa[ga[i]] >> iab;
      if (same_list) {
        gps.push_back({ga[i], ga[i + 1], ga[i], ga[i + 1]});
        continue;
      }
      while (j < ngb && ((*sb)[(*gb)[j]] >> iab) < ca) j++;
      if (j >= ngb) break;
      if (((*sb)[(*gb)[j]] >> iab) != ca) continue;
      gps.push_back({ga[i], ga[i + 1], (*gb)[j], (*gb)[j + 1]});
    }
  }

  // parallel emission of packed surviving pairs
  const int sh_ap = 0, sh_bp = f_ap, sh_bs = f_ap + f_bp,
            sh_as = f_ap + f_bp + f_bs;
  if (nthreads < 1) nthreads = 1;
  const int64_t ng = (int64_t)gps.size();
  std::vector<std::vector<uint64_t>> parts((size_t)nthreads);
  auto work = [&](int t) {
    std::vector<uint64_t> &out = parts[(size_t)t];
    for (int64_t g = t; g < ng; g += nthreads) {
      const GP &gp = gps[(size_t)g];
      const int64_t an = gp.a1 - gp.a0, bn = gp.b1 - gp.b0;
      if (maxfreq > 0 && (an > maxfreq || bn > maxfreq)) continue;
      if (selfcomp && same_list && an < 2) continue;
      for (int64_t x = gp.a0; x < gp.a1; x++) {
        const int64_t ai = (int64_t)(sa[x] & idxmask);
        const int64_t as = aseq[ai], ap = apos[ai];
        for (int64_t y = gp.b0; y < gp.b1; y++) {
          const int64_t bi = (int64_t)((*sb)[y] & idxmask);
          const int64_t bs = bseq[bi], bp = bpos[bi];
          if (selfcomp) {
            if (as > bs) continue;
            if (as == bs) {
              if (!inseqseeds) continue;
              if (ap + mindist > bp) continue;
              if (maxdist >= 0 && bp > ap + maxdist) continue;
            }
          }
          out.push_back(((uint64_t)as << sh_as) |
                        ((uint64_t)bs << sh_bs) |
                        ((uint64_t)bp << sh_bp) |
                        ((uint64_t)ap << sh_ap));
        }
      }
    }
  };
  if (nthreads == 1) {
    work(0);
  } else {
    std::vector<std::thread> th;
    for (int t = 0; t < nthreads; t++) th.emplace_back(work, t);
    for (auto &x : th) x.join();
  }
  int64_t total = 0;
  for (auto &p : parts) total += (int64_t)p.size();
  std::vector<uint64_t> pairs;
  pairs.reserve((size_t)total);
  for (auto &p : parts) {
    pairs.insert(pairs.end(), p.begin(), p.end());
    p.clear(); p.shrink_to_fit();
  }
  radix_u64_mt(pairs, f_as + f_bs + f_bp + f_ap, nthreads);

  int32_t *oas = (int32_t *)malloc(sizeof(int32_t) * (size_t)(total ? total : 1));
  int32_t *obs = (int32_t *)malloc(sizeof(int32_t) * (size_t)(total ? total : 1));
  int32_t *obp = (int32_t *)malloc(sizeof(int32_t) * (size_t)(total ? total : 1));
  int32_t *oap = (int32_t *)malloc(sizeof(int32_t) * (size_t)(total ? total : 1));
  if (!oas || !obs || !obp || !oap) {
    free(oas); free(obs); free(obp); free(oap);
    return -1;
  }
  const uint64_t m_ap = (1ull << f_ap) - 1, m_bp = (1ull << f_bp) - 1,
                 m_bs = (1ull << f_bs) - 1;
  for (int64_t i = 0; i < total; i++) {
    const uint64_t v = pairs[(size_t)i];
    oap[i] = (int32_t)(v & m_ap);
    obp[i] = (int32_t)((v >> sh_bp) & m_bp);
    obs[i] = (int32_t)((v >> sh_bs) & m_bs);
    oas[i] = (int32_t)(v >> sh_as);
  }
  *out_aseq = oas; *out_bseq = obs; *out_bpos = obp; *out_apos = oap;
  return total;
}

int64_t gt_seed_pair_join(
    const int64_t *acode, const int32_t *aseq, const int32_t *apos,
    int64_t na,
    const int64_t *bcode, const int32_t *bseq, const int32_t *bpos,
    int64_t nb,
    int same_list, int selfcomp, int inseqseeds,
    int64_t maxfreq, int64_t mindist, int64_t maxdist, int nthreads,
    int32_t **out_aseq, int32_t **out_bseq, int32_t **out_bpos,
    int32_t **out_apos) {
  return gt_seed_pair_join2(acode, aseq, apos, na, bcode, bseq, bpos,
                            nb, same_list, selfcomp, inseqseeds,
                            maxfreq, mindist, maxdist, nthreads, 0, 0,
                            nullptr, nullptr, out_aseq, out_bseq,
                            out_bpos, out_apos);
}

int64_t gt_tyr_lookup(const uint8_t *packed, int64_t nm, int merbytes,
                      const uint8_t *qpacked, int64_t nq,
                      int nthreads, int64_t *out_idx,
                      uint8_t *out_hit) {
  // big-endian packed rows compare bytewise == numerically: binary
  // search straight over the .mer plane, threaded over queries
  auto run = [&](int64_t q0, int64_t q1) {
    for (int64_t q = q0; q < q1; q++) {
      const uint8_t *qp = qpacked + q * merbytes;
      int64_t lo = 0, hi = nm;
      while (lo < hi) {
        const int64_t mid = (lo + hi) >> 1;
        if (std::memcmp(packed + mid * merbytes, qp,
                        (size_t)merbytes) < 0)
          lo = mid + 1;
        else
          hi = mid;
      }
      const int64_t ix = lo < nm ? lo : nm - 1;
      out_idx[q] = ix < 0 ? 0 : ix;
      out_hit[q] = (uint8_t)(lo < nm &&
                             std::memcmp(packed + lo * merbytes, qp,
                                         (size_t)merbytes) == 0);
    }
  };
  int T = nthreads < 2 || nq < (1 << 14) ? 1
                                         : (nthreads > 8 ? 8 : nthreads);
  if (T == 1) {
    run(0, nq);
  } else {
    std::vector<std::thread> th;
    for (int t = 0; t < T; t++)
      th.emplace_back(run, nq * t / T, nq * (t + 1) / T);
    for (auto &x : th) x.join();
  }
  return nq;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Readjoiner native kernels: FASTA -> clean read blob, unitig spelling.
// ---------------------------------------------------------------------------

extern "C" {

// Parse FASTA bytes into the 2-bit-clean read blob: acgt/ACGT encode to
// 0..3; reads containing any other non-whitespace symbol (or empty
// reads) are dropped whole (capability of reads2twobit prefiltering,
// ref: src/match/reads2twobit.c ambiguity skip). Returns the kept read
// count; *out_blob_len receives the blob length.
int64_t gt_fasta_clean_reads(const uint8_t *data, int64_t n,
                             uint8_t *out_blob, int64_t *out_lens,
                             int64_t *out_blob_len) {
  static uint8_t lut[256];
  static bool lut_ready = false;
  if (!lut_ready) {
    for (int i = 0; i < 256; i++) lut[i] = 4;   // 4 = bad symbol
    lut[(int)'a'] = lut[(int)'A'] = 0;
    lut[(int)'c'] = lut[(int)'C'] = 1;
    lut[(int)'g'] = lut[(int)'G'] = 2;
    lut[(int)'t'] = lut[(int)'T'] = 3;
    lut[(int)'\n'] = lut[(int)'\r'] = lut[(int)' '] = lut[(int)'\t'] =
        5;                                       // 5 = skip
    lut_ready = true;
  }
  int64_t nreads = 0, blob = 0;
  int64_t read_start = 0;     // blob offset of the current read
  bool in_read = false, bad = false, in_header = false;
  auto finish = [&]() {
    if (!in_read) return;
    const int64_t len = blob - read_start;
    if (bad || len == 0) {
      blob = read_start;      // drop the whole read
    } else {
      out_lens[nreads++] = len;
      read_start = blob;
    }
    in_read = false;
  };
  for (int64_t i = 0; i < n; i++) {
    const uint8_t c = data[i];
    if (in_header) {
      if (c == '\n') in_header = false;
      continue;
    }
    if (c == '>') {
      finish();
      in_header = true;
      in_read = true;          // the read starts after this header
      bad = false;
      continue;
    }
    const uint8_t v = lut[c];
    if (v == 5) continue;
    if (v == 4) {
      bad = true;
      continue;
    }
    out_blob[blob++] = v;
  }
  finish();
  *out_blob_len = blob;
  return nreads;
}

// FASTA -> encseq codes in one pass: headers to (start, end) byte
// spans, payload bytes mapped through the caller-provided alphabet LUT
// (exact alphabet.encode semantics), SEPARATOR (255) between
// sequences.  Whitespace inside payload is skipped.  Returns the
// sequence count; *out_codes_len receives the code length (incl.
// separators).
int64_t gt_fasta_encseq(const uint8_t *data, int64_t n,
                        const uint8_t *lut, uint8_t *out_codes,
                        int64_t *out_lens, int64_t *out_hdr_start,
                        int64_t *out_hdr_end, uint8_t *out_seen,
                        int64_t *out_codes_len) {
  int64_t nseq = 0, w = 0, seq_start = 0;
  bool in_header = false, any = false;
  for (int64_t i = 0; i < n; i++) {
    const uint8_t c = data[i];
    if (in_header) {
      if (c == '\n') {
        in_header = false;
        int64_t e = i;
        if (e > out_hdr_start[nseq - 1] && data[e - 1] == '\r') e--;
        out_hdr_end[nseq - 1] = e;
      }
      continue;
    }
    if (c == '>') {
      if (any) {
        out_lens[nseq - 1] = w - seq_start;
        out_codes[w++] = 255;  // SEPARATOR
      }
      any = true;
      in_header = true;
      out_hdr_start[nseq] = i + 1;
      out_hdr_end[nseq] = i + 1;
      nseq++;
      seq_start = w;
      continue;
    }
    if (c == '\n' || c == '\r' || c == ' ' || c == '\t') continue;
    out_seen[c] = 1;
    out_codes[w++] = lut[c];
  }
  if (any) out_lens[nseq - 1] = w - seq_start;
  *out_codes_len = w;
  return nseq;
}

// Unitig spelling walk (capability of gt_strgraph_spell, ref:
// src/match/rdj-strgraph.c:2760) over source-sorted edge planes.
// Vertices are read*2 + strand; runs[v]..runs[v+1] index the edges out
// of v in (sb, sl). Outputs: per-contig code blob (concatenated),
// contig lengths, depths, start/end vertices -- identical stream to the
// Python walk (start order: per read, strand True before False).
int64_t gt_strgraph_spell(const int64_t *sb, const int64_t *sl,
                          const int64_t *runs, const int64_t *indeg,
                          int64_t nverts2, const uint8_t *blob,
                          const uint8_t *rcblob, const int64_t *starts,
                          const int64_t *lens, int64_t nreads,
                          int64_t min_depth, int64_t min_length,
                          uint8_t *out_blob, int64_t *out_lens,
                          int64_t *out_depth, int64_t *out_sv,
                          int64_t *out_ev, int64_t *out_blob_len) {
  std::vector<uint8_t> used((size_t)nreads, 0);
  std::vector<int64_t> path;    // vertices
  std::vector<int64_t> ovls;    // overlaps per hop
  int64_t ncontig = 0, ob = 0;
  auto seq_ptr = [&](int64_t v) {
    const int64_t r = v >> 1;
    return ((v & 1) ? blob : rcblob) + starts[r];
  };
  for (int64_t r = 0; r < nreads; r++) {
    for (int s = 1; s >= 0; s--) {      // strand True first
      const int64_t v0 = r * 2 + s;
      if (v0 >= nverts2) continue;
      if (indeg[v0] == 1 || runs[v0 + 1] - runs[v0] < 1) continue;
      if (used[(size_t)(v0 >> 1)]) continue;
      path.clear();
      ovls.clear();
      path.push_back(v0);
      int64_t v = v0;
      for (;;) {
        int64_t pick = -1, cnt = 0;
        for (int64_t e = runs[v]; e < runs[v + 1]; e++) {
          const int64_t b = sb[e];
          if (used[(size_t)(b >> 1)] || (b >> 1) == (v >> 1)) continue;
          cnt++;
          pick = e;
          if (cnt > 1) break;
        }
        if (cnt != 1) break;
        const int64_t b = sb[pick];
        if (indeg[b] != 1) break;
        path.push_back(b);
        ovls.push_back(sl[pick]);
        used[(size_t)(v >> 1)] = 1;
        v = b;
      }
      for (int64_t p : path) used[(size_t)(p >> 1)] = 1;
      if ((int64_t)path.size() < 2) continue;
      const int64_t cstart = ob;
      {
        const int64_t r0 = path[0] >> 1;
        std::memcpy(out_blob + ob, seq_ptr(path[0]), (size_t)lens[r0]);
        ob += lens[r0];
      }
      for (size_t h = 1; h < path.size(); h++) {
        const int64_t rr = path[h] >> 1;
        const int64_t l = ovls[h - 1];
        std::memcpy(out_blob + ob, seq_ptr(path[h]) + l,
                    (size_t)(lens[rr] - l));
        ob += lens[rr] - l;
      }
      const int64_t clen = ob - cstart;
      if ((int64_t)path.size() >= min_depth && clen >= min_length) {
        out_lens[ncontig] = clen;
        out_depth[ncontig] = (int64_t)path.size();
        out_sv[ncontig] = path.front();
        out_ev[ncontig] = path.back();
        ncontig++;
      } else {
        ob = cstart;            // rejected: rewind the blob
      }
    }
  }
  *out_blob_len = ob;
  return ncontig;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Suffix-prefix-match (SPM) finder: the readjoiner overlap phase's hot
// join (capability of firstcodes + gt_spmsk, ref: src/match/firstcodes.c
// + esa-spmsk.c; brute-force oracle rdj-ovlfind-bf.c).
//
// blob holds the mirrored read symbols (values 0..3); a window of
// length k at suffix offset `off` of read a matches read b's k-prefix
// iff their rolling 2-bit codes agree; the tail [k, L) is then
// memcmp-verified.  A 2^24-bit presence filter in front of the sorted
// prefix-code array rejects nearly every window without a binary
// search.  Threads take contiguous read ranges; per-thread outputs are
// concatenated in range order, so emission order equals the numpy
// engine's ascending-position order.
// ---------------------------------------------------------------------------

extern "C" {

// Returns SPM count; fills malloc'd int64 planes (caller gt_free's).
// strand_canon: apply the mirrored-dual rule a + b <= m_count-1.
int64_t gt_spm_find(const uint8_t *blob, const int64_t *starts,
                    const int64_t *lens, int64_t m_count,
                    int64_t k, int64_t minlen, int strand_canon,
                    int nthreads,
                    int64_t **out_a, int64_t **out_b, int64_t **out_l) {
  if (m_count <= 0 || k <= 0 || k > 31) return -2;
  // sorted (prefix code, read) list over reads with len >= k
  std::vector<std::pair<uint64_t, int64_t>> pref;
  pref.reserve((size_t)m_count);
  for (int64_t r = 0; r < m_count; r++) {
    if (lens[r] < k) continue;
    uint64_t c = 0;
    const uint8_t *p = blob + starts[r];
    for (int64_t j = 0; j < k; j++) c = (c << 2) | p[j];
    pref.emplace_back(c, r);
  }
  std::sort(pref.begin(), pref.end());
  const size_t np = pref.size();
  std::vector<uint64_t> pcodes(np);
  for (size_t i = 0; i < np; i++) pcodes[i] = pref[i].first;
  // 2^24-bit presence filter
  const uint64_t FB = 24, FMASK = (1ull << FB) - 1;
  std::vector<uint64_t> filt((size_t)1 << (FB - 6), 0);
  for (size_t i = 0; i < np; i++) {
    const uint64_t h = pcodes[i] & FMASK;
    filt[h >> 6] |= 1ull << (h & 63);
  }
  const uint64_t kmask =
      (k == 32) ? ~0ull : ((1ull << (2 * k)) - 1);

  if (nthreads < 1) nthreads = 1;
  struct Hit { int64_t a, b, l; };
  std::vector<std::vector<Hit>> parts((size_t)nthreads);
  // contiguous read ranges balanced by total length
  std::vector<int64_t> rsplit((size_t)nthreads + 1, 0);
  {
    int64_t total_syms = 0;
    for (int64_t r = 0; r < m_count; r++) total_syms += lens[r];
    int64_t acc = 0, t = 1;
    for (int64_t r = 0; r < m_count && t < nthreads; r++) {
      acc += lens[r];
      if (acc >= total_syms * t / nthreads) rsplit[(size_t)t++] = r + 1;
    }
    for (; t <= nthreads; t++) rsplit[(size_t)t] = m_count;
  }
  auto work = [&](int t) {
    std::vector<Hit> &out = parts[(size_t)t];
    for (int64_t a = rsplit[(size_t)t]; a < rsplit[(size_t)t + 1];
         a++) {
      const int64_t la = lens[a], sa = starts[a];
      if (la < minlen) continue;
      const uint8_t *p = blob + sa;
      uint64_t code = 0;
      for (int64_t j = 0; j < k; j++) code = (code << 2) | p[j];
      const int64_t maxoff = la - minlen;
      for (int64_t off = 0;; off++) {
        if (off > 0)
          code = ((code << 2) | (uint64_t)p[off + k - 1]) & kmask;
        const uint64_t h = code & FMASK;
        if (filt[h >> 6] & (1ull << (h & 63))) {
          auto lo = std::lower_bound(pcodes.begin(), pcodes.end(),
                                     code) - pcodes.begin();
          const int64_t L = la - off;
          for (size_t i = (size_t)lo;
               i < np && pcodes[i] == code; i++) {
            const int64_t b = pref[i].second;
            if (b == a || L >= la || L >= lens[b]) continue;
            if (strand_canon && a + b > m_count - 1) continue;
            if (L > k &&
                std::memcmp(p + off + k, blob + starts[b] + k,
                            (size_t)(L - k)) != 0)
              continue;
            out.push_back({a, b, L});
          }
        }
        if (off >= maxoff) break;
      }
    }
  };
  if (nthreads == 1) {
    work(0);
  } else {
    std::vector<std::thread> th;
    for (int t = 0; t < nthreads; t++) th.emplace_back(work, t);
    for (auto &x : th) x.join();
  }
  int64_t total = 0;
  for (auto &pt : parts) total += (int64_t)pt.size();
  int64_t *oa = (int64_t *)malloc(sizeof(int64_t) *
                                  (size_t)(total ? total : 1));
  int64_t *ob = (int64_t *)malloc(sizeof(int64_t) *
                                  (size_t)(total ? total : 1));
  int64_t *ol = (int64_t *)malloc(sizeof(int64_t) *
                                  (size_t)(total ? total : 1));
  if (!oa || !ob || !ol) { free(oa); free(ob); free(ol); return -1; }
  int64_t w = 0;
  for (auto &pt : parts)
    for (const Hit &h : pt) { oa[w] = h.a; ob[w] = h.b; ol[w] = h.l; w++; }
  *out_a = oa; *out_b = ob; *out_l = ol;
  return total;
}

}  // extern "C"
