// CPU oracle: from-scratch C++ implementation of cross-scale PatchMatch
// stereo with the reference's sequential semantics.
//
// Purpose (SURVEY.md sections 4/6): the upstream reference is a Windows/VS2010
// project that cannot run here, and it publishes no benchmark numbers.  This
// oracle re-implements the documented behavior -- sequential raster
// propagation, scatter view propagation, halving plane refinement, ASW window
// costs over precomputed volumes with inter-slice lerp, cross-scale
// aggregation, LR-check/fill/weighted-median post-processing -- so the repo
// can (a) MEASURE the CPU wall-clock baseline that bench.py reports against
// and (b) produce end-to-end disparity maps for accuracy comparison with the
// JAX engine.  It is written fresh against the behavior notes in SURVEY.md
// (semantics cited per function); it is not a copy of the reference sources.
//
// Build: g++ -O3 -march=native -fopenmp -shared -fPIC -std=c++17
//        -o libcspm_oracle.so cspm_oracle.cc
// (crossscalepatchmatch/oracle.py builds it on demand and binds via
// ctypes.)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <random>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// ---------------------------------------------------------------------------
// Basic containers
// ---------------------------------------------------------------------------

struct Img {                 // planar double image, 3 channels
  int h = 0, w = 0;
  std::vector<double> c0, c1, c2;  // BGR order as loaded
  double at(int ch, int y, int x) const {
    const std::vector<double>& c = ch == 0 ? c0 : (ch == 1 ? c1 : c2);
    return c[static_cast<size_t>(y) * w + x];
  }
};

struct Plane {               // disparity plane d(x, y) = a x + b y + c
  double a = 0, b = 0, c = 0;
};

struct State {
  std::vector<Plane> plane[2];
  std::vector<double> cost[2];
};

// Cost volume: per view, (max_dis + 1) slices of h*w doubles.
struct Volume {
  int h = 0, w = 0, d = 0;
  std::vector<double> v;     // [d+1][h][w]
  double maxc = 0;
  double at(int dd, int y, int x) const {
    return v[(static_cast<size_t>(dd) * h + y) * w + x];
  }
  double& at(int dd, int y, int x) {
    return v[(static_cast<size_t>(dd) * h + y) * w + x];
  }
};

// ---------------------------------------------------------------------------
// Matching costs (cost-volume builders)
// ---------------------------------------------------------------------------

// TAD color + x-gradient cost (semantics of cc/grd_cc.cpp:4-154): mean |RGB
// diff| truncated at tau_clr mixed with |x-Sobel(ksize=1) gray diff|
// truncated at tau_grd, alpha*clr + (1-alpha)*grd; columns shifted past the
// border compare against the constant BORDER=3.
constexpr double kAlpha = 0.1, kTauClr = 10.0, kTauGrd = 2.0, kBorder = 3.0;

std::vector<double> gray_of(const Img& im) {
  // Gray from RGB with the standard BT.601 weights; the engine's builder
  // uses the same convention (ops/color.py).  Input Img is BGR planes.
  std::vector<double> g(static_cast<size_t>(im.h) * im.w);
  for (int y = 0; y < im.h; ++y)
    for (int x = 0; x < im.w; ++x)
      g[static_cast<size_t>(y) * im.w + x] =
          0.299 * im.at(2, y, x) + 0.587 * im.at(1, y, x) +
          0.114 * im.at(0, y, x);
  return g;
}

std::vector<double> sobel_x1(const std::vector<double>& g, int h, int w) {
  std::vector<double> out(static_cast<size_t>(h) * w, 0.0);
  for (int y = 0; y < h; ++y)
    for (int x = 1; x < w - 1; ++x)
      out[static_cast<size_t>(y) * w + x] =
          g[static_cast<size_t>(y) * w + x + 1] -
          g[static_cast<size_t>(y) * w + x - 1];
  return out;
}

void build_grd(const Img& l, const Img& r, int max_dis, bool right,
               Volume* vol) {
  const int h = l.h, w = l.w;
  vol->h = h; vol->w = w; vol->d = max_dis;
  vol->v.assign(static_cast<size_t>(max_dis + 1) * h * w, 0.0);
  std::vector<double> lg = sobel_x1(gray_of(l), h, w);
  std::vector<double> rg = sobel_x1(gray_of(r), h, w);
  const Img& ref = right ? r : l;
  const Img& oth = right ? l : r;
  const std::vector<double>& refg = right ? rg : lg;
  const std::vector<double>& othg = right ? lg : rg;
  const int sign = right ? 1 : -1;
  for (int d = 0; d <= max_dis; ++d) {
    for (int y = 0; y < h; ++y) {
      for (int x = 0; x < w; ++x) {
        int xo = x + sign * d;
        double clr, grd;
        if (xo >= 0 && xo < w) {
          clr = (std::abs(ref.at(0, y, x) - oth.at(0, y, xo)) +
                 std::abs(ref.at(1, y, x) - oth.at(1, y, xo)) +
                 std::abs(ref.at(2, y, x) - oth.at(2, y, xo))) / 3.0;
          grd = std::abs(refg[static_cast<size_t>(y) * w + x] -
                         othg[static_cast<size_t>(y) * w + xo]);
        } else {
          clr = (std::abs(ref.at(0, y, x) - kBorder) +
                 std::abs(ref.at(1, y, x) - kBorder) +
                 std::abs(ref.at(2, y, x) - kBorder)) / 3.0;
          grd = std::abs(refg[static_cast<size_t>(y) * w + x] - kBorder);
        }
        vol->at(d, y, x) = kAlpha * std::min(clr, kTauClr) +
                           (1.0 - kAlpha) * std::min(grd, kTauGrd);
      }
    }
  }
}

// 9x9 census-Hamming cost (semantics of cc/cen_cc.cc:4-138): 80 comparison
// bits against the center on 8-bit gray with wrap-around window borders;
// out-of-range columns cost the full 80.
void build_census(const Img& l, const Img& r, int max_dis, bool right,
                  Volume* vol) {
  const int h = l.h, w = l.w, rad = 4;
  vol->h = h; vol->w = w; vol->d = max_dis;
  vol->v.assign(static_cast<size_t>(max_dis + 1) * h * w, 0.0);

  auto gray_u8 = [](const Img& im) {
    // Fixed-point BT.601 gray, identical to the engine's rgb_to_gray_u8
    // (ops/color.py) so census bits agree exactly.
    std::vector<uint8_t> g(static_cast<size_t>(im.h) * im.w);
    for (int y = 0; y < im.h; ++y)
      for (int x = 0; x < im.w; ++x) {
        long rr = std::lround(im.at(2, y, x));
        long gg = std::lround(im.at(1, y, x));
        long bb = std::lround(im.at(0, y, x));
        g[static_cast<size_t>(y) * im.w + x] = static_cast<uint8_t>(
            (rr * 4899 + gg * 9617 + bb * 1868 + (1l << 13)) >> 14);
      }
    return g;
  };
  auto census_of = [&](const std::vector<uint8_t>& g) {
    // 81 window positions, center excluded -> 80 bits in two uint64 words.
    std::vector<uint64_t> lo(static_cast<size_t>(h) * w),
        hi(static_cast<size_t>(h) * w);
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x) {
        uint64_t wlo = 0, whi = 0;
        int bit = 0;
        uint8_t ctr = g[static_cast<size_t>(y) * w + x];
        for (int dy = -rad; dy <= rad; ++dy)
          for (int dx = -rad; dx <= rad; ++dx) {
            if (dy == 0 && dx == 0) continue;
            int qy = (y + dy + h) % h;          // wrap borders
            int qx = (x + dx + w) % w;
            int v = ctr > g[static_cast<size_t>(qy) * w + qx] ? 1 : 0;
            if (bit < 64) wlo |= static_cast<uint64_t>(v) << bit;
            else whi |= static_cast<uint64_t>(v) << (bit - 64);
            ++bit;
          }
        lo[static_cast<size_t>(y) * w + x] = wlo;
        hi[static_cast<size_t>(y) * w + x] = whi;
      }
    return std::make_pair(lo, hi);
  };

  auto [llo, lhi] = census_of(gray_u8(l));
  auto [rlo, rhi] = census_of(gray_u8(r));
  const auto& alo = right ? rlo : llo;
  const auto& ahi = right ? rhi : lhi;
  const auto& blo = right ? llo : rlo;
  const auto& bhi = right ? lhi : rhi;
  const int sign = right ? 1 : -1;
  for (int d = 0; d <= max_dis; ++d)
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x) {
        int xo = x + sign * d;
        double c = 80.0;
        if (xo >= 0 && xo < w) {
          size_t ia = static_cast<size_t>(y) * w + x;
          size_t ib = static_cast<size_t>(y) * w + xo;
          c = static_cast<double>(__builtin_popcountll(alo[ia] ^ blo[ib]) +
                                  __builtin_popcountll(ahi[ia] ^ bhi[ib]));
        }
        vol->at(d, y, x) = c;
      }
}

// ---------------------------------------------------------------------------
// Pyramid (cross-scale)
// ---------------------------------------------------------------------------

// pyrDown semantics: 5x5 Gaussian blur + 2x decimation with reflected
// borders, output size (n + 1) / 2 (pre_cs_pc.cc:42-49).
Img pyr_down(const Img& in) {
  static const double k[5] = {1.0 / 16, 4.0 / 16, 6.0 / 16, 4.0 / 16,
                              1.0 / 16};
  Img out;
  out.h = (in.h + 1) / 2;
  out.w = (in.w + 1) / 2;
  auto reflect = [](int i, int n) {
    if (i < 0) i = -i;
    if (i >= n) i = 2 * n - 2 - i;
    return std::min(std::max(i, 0), n - 1);
  };
  for (auto pc : {0, 1, 2}) {
    const std::vector<double>& src =
        pc == 0 ? in.c0 : (pc == 1 ? in.c1 : in.c2);
    std::vector<double> tmp(static_cast<size_t>(in.h) * in.w);
    for (int y = 0; y < in.h; ++y)        // horizontal pass
      for (int x = 0; x < in.w; ++x) {
        double s = 0;
        for (int t = -2; t <= 2; ++t)
          s += k[t + 2] * src[static_cast<size_t>(y) * in.w +
                              reflect(x + t, in.w)];
        tmp[static_cast<size_t>(y) * in.w + x] = s;
      }
    std::vector<double>& dst =
        pc == 0 ? out.c0 : (pc == 1 ? out.c1 : out.c2);
    dst.assign(static_cast<size_t>(out.h) * out.w, 0.0);
    for (int y = 0; y < out.h; ++y)       // vertical pass + decimate
      for (int x = 0; x < out.w; ++x) {
        double s = 0;
        for (int t = -2; t <= 2; ++t)
          s += k[t + 2] * tmp[static_cast<size_t>(reflect(2 * y + t, in.h)) *
                                  in.w + 2 * x];
        dst[static_cast<size_t>(y) * out.w + x] = s;
      }
  }
  return out;
}

// Inter-scale regularization weights: row 0 of the inverse of the
// tridiagonal matrix with diag 1+lambda (ends) / 1+2 lambda (middle) and
// off-diag -lambda (pre_cs_pc.cc:85-109).
std::vector<double> scale_weights(int s, double lam) {
  std::vector<double> m(static_cast<size_t>(s) * s, 0.0);
  for (int i = 0; i < s; ++i) {
    m[static_cast<size_t>(i) * s + i] =
        (i == 0 || i == s - 1) ? 1 + lam : 1 + 2 * lam;
    if (i > 0) m[static_cast<size_t>(i) * s + i - 1] = -lam;
    if (i < s - 1) m[static_cast<size_t>(i) * s + i + 1] = -lam;
  }
  if (lam == 0.0) {
    std::vector<double> w(s, 0.0);
    w[0] = 1.0;
    return w;
  }
  // Gauss-Jordan inverse of the small s x s system; keep row 0.
  std::vector<double> inv(static_cast<size_t>(s) * s, 0.0);
  for (int i = 0; i < s; ++i) inv[static_cast<size_t>(i) * s + i] = 1.0;
  for (int col = 0; col < s; ++col) {
    int piv = col;
    for (int rr = col + 1; rr < s; ++rr)
      if (std::abs(m[static_cast<size_t>(rr) * s + col]) >
          std::abs(m[static_cast<size_t>(piv) * s + col]))
        piv = rr;
    for (int cc = 0; cc < s; ++cc) {
      std::swap(m[static_cast<size_t>(col) * s + cc],
                m[static_cast<size_t>(piv) * s + cc]);
      std::swap(inv[static_cast<size_t>(col) * s + cc],
                inv[static_cast<size_t>(piv) * s + cc]);
    }
    double p = m[static_cast<size_t>(col) * s + col];
    for (int cc = 0; cc < s; ++cc) {
      m[static_cast<size_t>(col) * s + cc] /= p;
      inv[static_cast<size_t>(col) * s + cc] /= p;
    }
    for (int rr = 0; rr < s; ++rr) {
      if (rr == col) continue;
      double f = m[static_cast<size_t>(rr) * s + col];
      for (int cc = 0; cc < s; ++cc) {
        m[static_cast<size_t>(rr) * s + cc] -=
            f * m[static_cast<size_t>(col) * s + cc];
        inv[static_cast<size_t>(rr) * s + cc] -=
            f * inv[static_cast<size_t>(col) * s + cc];
      }
    }
  }
  return std::vector<double>(inv.begin(), inv.begin() + s);
}

// ---------------------------------------------------------------------------
// Plane cost (ASW window over precomputed volumes, optional cross-scale)
// ---------------------------------------------------------------------------

struct PlaneCost {
  // Level 0 first; single-scale uses one level.
  std::vector<Img> imgs[2];          // per view, per scale (BGR doubles)
  std::vector<Volume> vols[2];       // per view, per scale
  std::vector<double> wgts;          // per-scale weights
  int wnd = 35, max_dis = 60;
  double gamma = 10.0;

  // ASW window cost of `pl` at (x, y): per scale, re-anchor the plane
  // through the decimated point with the same orientation, accumulate
  // exp(-L1/gamma)-weighted inter-slice lerps; skip window pixels outside
  // the image; saturate out-of-range disparities to max(volume)
  // (pre_ss_pc.cc:74-118, pre_cs_pc.cc:133-188).
  double eval(int view, int x, int y, const Plane& pl) const {
    const int half = wnd / 2;
    double total = 0.0;
    int md = max_dis;
    for (size_t s = 0; s < wgts.size(); ++s, md /= 2) {
      const Img& im = imgs[view][s];
      const Volume& vol = vols[view][s];
      const int xs = x >> s, ys = y >> s;
      const double d0 = (pl.a * x + pl.b * y + pl.c) / double(1 << s);
      // re-anchored plane: same (a, b), passes through (xs, ys, d0)
      const double cs = d0 - pl.a * xs - pl.b * ys;
      double acc = 0.0;
      for (int dy = -half; dy <= half; ++dy) {
        const int qy = ys + dy;
        if (qy < 0 || qy >= im.h) continue;
        for (int dx = -half; dx <= half; ++dx) {
          const int qx = xs + dx;
          if (qx < 0 || qx >= im.w) continue;
          const double l1 = std::abs(im.at(0, ys, xs) - im.at(0, qy, qx)) +
                            std::abs(im.at(1, ys, xs) - im.at(1, qy, qx)) +
                            std::abs(im.at(2, ys, xs) - im.at(2, qy, qx));
          const double wgt = std::exp(-l1 / gamma);
          const double dq = pl.a * qx + pl.b * qy + cs;
          const int f = static_cast<int>(dq);   // C trunc
          double val;
          if (f < 1 || f > md - 1) {
            val = vol.maxc;
          } else {
            const double fw = (f + 1) - dq;
            val = fw * vol.at(f, qy, qx) + (1.0 - fw) * vol.at(f + 1, qy, qx);
          }
          acc += wgt * val;
        }
      }
      total += wgts[s] * acc;
    }
    return total;
  }
};

// ---------------------------------------------------------------------------
// PatchMatch optimizer (sequential reference semantics)
// ---------------------------------------------------------------------------

struct Params {
  int h, w, max_dis, dis_scale, max_iter, wnd;
  bool use_pp;
  unsigned seed;
};

void init_random(const Params& p, const PlaneCost& pc, State* st) {
  for (int v = 0; v < 2; ++v) {
    st->plane[v].resize(static_cast<size_t>(p.h) * p.w);
    st->cost[v].resize(static_cast<size_t>(p.h) * p.w);
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 1)
#endif
    for (int y = 0; y < p.h; ++y) {
      std::mt19937 rng(p.seed + 1315423911u * (v * p.h + y));
      std::uniform_real_distribution<double> ud(1e-8, double(p.max_dis));
      std::normal_distribution<double> nd(0.0, 1.0);
      for (int x = 0; x < p.w; ++x) {
        double d = ud(rng);
        double nx = nd(rng), ny = nd(rng), nz = nd(rng);
        double nn = std::max(std::sqrt(nx * nx + ny * ny + nz * nz), 1e-8);
        nx /= nn; ny /= nn; nz /= nn;
        double dz = std::abs(nz) < 1e-8 ? (nz < 0 ? -1e-8 : 1e-8) : nz;
        Plane pl;
        pl.a = -nx / dz;
        pl.b = -ny / dz;
        pl.c = (nx * x + ny * y + nz * d) / dz;
        size_t i = static_cast<size_t>(y) * p.w + x;
        st->plane[v][i] = pl;
        st->cost[v][i] = pc.eval(v, x, y, pl);
      }
    }
  }
}

inline void try_adopt(const PlaneCost& pc, State* st, int v, int x, int y,
                      const Plane& cand, int w) {
  size_t i = static_cast<size_t>(y) * w + x;
  double c = pc.eval(v, x, y, cand);
  if (c < st->cost[v][i]) {
    st->cost[v][i] = c;
    st->plane[v][i] = cand;
  }
}

// Sequential raster scan: even iterations top-left to bottom-right testing
// the already-updated left/top neighbors, odd iterations reversed
// (cs_patchmatch.cc:163-216).
void spatial_prop(const Params& p, const PlaneCost& pc, State* st, int it) {
  const int w = p.w, h = p.h;
  const bool fwd = (it % 2 == 0);
  for (int v = 0; v < 2; ++v) {
    if (fwd) {
      for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x) {
          if (x > 0)
            try_adopt(pc, st, v, x, y,
                      st->plane[v][static_cast<size_t>(y) * w + x - 1], w);
          if (y > 0)
            try_adopt(pc, st, v, x, y,
                      st->plane[v][static_cast<size_t>(y - 1) * w + x], w);
        }
    } else {
      for (int y = h - 1; y >= 0; --y)
        for (int x = w - 1; x >= 0; --x) {
          if (x < w - 1)
            try_adopt(pc, st, v, x, y,
                      st->plane[v][static_cast<size_t>(y) * w + x + 1], w);
          if (y < h - 1)
            try_adopt(pc, st, v, x, y,
                      st->plane[v][static_cast<size_t>(y + 1) * w + x], w);
        }
    }
  }
}

// Scatter view propagation: every pixel of the OTHER view projects its
// plane into this view at the warped column and the target adopts it if
// cheaper (cs_patchmatch.cc:229-277).
void view_prop(const Params& p, const PlaneCost& pc, State* st) {
  const int w = p.w, h = p.h;
  for (int v = 0; v < 2; ++v) {
    const int o = 1 - v;
    const int sign = (o == 0) ? -1 : 1;  // left pixels map right by -d
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x) {
        const Plane& pl = st->plane[o][static_cast<size_t>(y) * w + x];
        double d = pl.a * x + pl.b * y + pl.c;
        d = std::min(std::max(d, 0.0), double(p.max_dis - 1));
        int cx = x + sign * static_cast<int>(std::lround(d));
        if (cx < 0) cx += w;              // wrap like HandleBorder
        if (cx >= w) cx -= w;
        Plane cand;
        cand.a = pl.a; cand.b = pl.b;
        cand.c = d - pl.a * cx - pl.b * y;
        try_adopt(pc, st, v, cx, y, cand, w);
      }
  }
}

// Halving-schedule refinement: z from max_dis/2 to <0.1, normal magnitude
// halving in lockstep; perturb and adopt if cheaper, OpenMP rows
// (cs_patchmatch.cc:292-345).
void refine(const Params& p, const PlaneCost& pc, State* st, int it) {
  for (double z = p.max_dis / 2.0, n = 1.0; z >= 0.1; z /= 2.0, n /= 2.0) {
    for (int v = 0; v < 2; ++v) {
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 1)
#endif
      for (int y = 0; y < p.h; ++y) {
        std::mt19937 rng(p.seed ^ (2654435761u * (((it * 2 + v) * p.h + y) +
                                                  static_cast<int>(z * 97))));
        std::uniform_real_distribution<double> uz(-z, z);
        std::uniform_real_distribution<double> un(-n, n);
        for (int x = 0; x < p.w; ++x) {
          size_t i = static_cast<size_t>(y) * p.w + x;
          const Plane& cur = st->plane[v][i];
          double d = cur.a * x + cur.b * y + cur.c + uz(rng);
          double len = std::sqrt(cur.a * cur.a + cur.b * cur.b + 1.0);
          double nx = -cur.a / len + un(rng);
          double ny = -cur.b / len + un(rng);
          double nz = 1.0 / len + un(rng);
          double nn = std::max(std::sqrt(nx * nx + ny * ny + nz * nz), 1e-8);
          nx /= nn; ny /= nn; nz /= nn;
          double dz = std::abs(nz) < 1e-8 ? (nz < 0 ? -1e-8 : 1e-8) : nz;
          Plane cand;
          cand.a = -nx / dz;
          cand.b = -ny / dz;
          cand.c = (nx * x + ny * y + nz * d) / dz;
          double c = pc.eval(v, x, y, cand);
          if (c < st->cost[v][i]) {
            st->cost[v][i] = c;
            st->plane[v][i] = cand;
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Post-processing (cs_patchmatch.cc:347-588)
// ---------------------------------------------------------------------------

void plane_to_disp(const Params& p, const State& st, uint8_t* out) {
  for (int v = 0; v < 2; ++v)
    for (int y = 0; y < p.h; ++y)
      for (int x = 0; x < p.w; ++x) {
        const Plane& pl = st.plane[v][static_cast<size_t>(y) * p.w + x];
        double d = (pl.a * x + pl.b * y + pl.c) * p.dis_scale;
        long r = std::lround(d);
        out[(static_cast<size_t>(v) * p.h + y) * p.w + x] =
            static_cast<uint8_t>(std::min(255l, std::max(0l, r)));
      }
}

void post_process(const Params& p, const PlaneCost& pc, const State& st,
                  uint8_t* dis) {
  const int h = p.h, w = p.w;
  std::vector<uint8_t> valid(static_cast<size_t>(2) * h * w, 0);
  auto dval = [&](int v, int y, int x) {
    return dis[(static_cast<size_t>(v) * h + y) * w + x] /
           double(p.dis_scale);
  };
  // LR check
  for (int v = 0; v < 2; ++v) {
    const int sign = v == 0 ? -1 : 1;
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x) {
        double d = dval(v, y, x);
        int xo = x + sign * static_cast<int>(std::lround(d));
        bool ok = d > 0 && xo >= 0 && xo < w &&
                  std::abs(d - dval(1 - v, y, xo)) <= 0.5;
        valid[(static_cast<size_t>(v) * h + y) * w + x] = ok;
      }
  }
  // Fill invalid from nearest valid left/right pixels' planes (min disparity)
  for (int v = 0; v < 2; ++v)
    for (int y = 0; y < h; ++y) {
      for (int x = 0; x < w; ++x) {
        if (valid[(static_cast<size_t>(v) * h + y) * w + x]) continue;
        int xl = x - 1, xr = x + 1;
        while (xl >= 0 && !valid[(static_cast<size_t>(v) * h + y) * w + xl])
          --xl;
        while (xr < w && !valid[(static_cast<size_t>(v) * h + y) * w + xr])
          ++xr;
        double dl = 1e100, dr = 1e100;
        if (xl >= 0) {
          const Plane& pl = st.plane[v][static_cast<size_t>(y) * w + xl];
          dl = pl.a * x + pl.b * y + pl.c;
        }
        if (xr < w) {
          const Plane& pl = st.plane[v][static_cast<size_t>(y) * w + xr];
          dr = pl.a * x + pl.b * y + pl.c;
        }
        if (xl < 0 && xr >= w) continue;
        double d = std::min(dl, dr) * p.dis_scale;
        long r = std::lround(d);
        dis[(static_cast<size_t>(v) * h + y) * w + x] =
            static_cast<uint8_t>(std::min(255l, std::max(0l, r)));
      }
    }
  // Weighted median at formerly-invalid pixels over the level-0 image
  const int half = p.wnd / 2;
  std::vector<uint8_t> out(dis, dis + static_cast<size_t>(2) * h * w);
  for (int v = 0; v < 2; ++v) {
    const Img& im = pc.imgs[v][0];
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 1)
#endif
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x) {
        if (valid[(static_cast<size_t>(v) * h + y) * w + x]) continue;
        double hist[256] = {0};
        double total = 0;
        for (int dy = -half; dy <= half; ++dy) {
          int qy = y + dy;
          if (qy < 0 || qy >= h) continue;
          for (int dx = -half; dx <= half; ++dx) {
            int qx = x + dx;
            if (qx < 0 || qx >= w) continue;
            if (!valid[(static_cast<size_t>(v) * h + qy) * w + qx]) continue;
            double l1 = std::abs(im.at(0, y, x) - im.at(0, qy, qx)) +
                        std::abs(im.at(1, y, x) - im.at(1, qy, qx)) +
                        std::abs(im.at(2, y, x) - im.at(2, qy, qx));
            double wgt = std::exp(-l1 / 10.0);
            hist[dis[(static_cast<size_t>(v) * h + qy) * w + qx]] += wgt;
            total += wgt;
          }
        }
        if (total <= 0) continue;
        double acc = 0;
        for (int t = 0; t < 256; ++t) {
          acc += hist[t];
          if (acc >= total / 2) {
            out[(static_cast<size_t>(v) * h + y) * w + x] =
                static_cast<uint8_t>(t);
            break;
          }
        }
      }
  }
  std::memcpy(dis, out.data(), out.size());
}

Img to_img(const uint8_t* bgr, int h, int w) {
  Img im;
  im.h = h; im.w = w;
  im.c0.resize(static_cast<size_t>(h) * w);
  im.c1.resize(static_cast<size_t>(h) * w);
  im.c2.resize(static_cast<size_t>(h) * w);
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x) {
      size_t i = static_cast<size_t>(y) * w + x;
      im.c0[i] = bgr[i * 3 + 0];
      im.c1[i] = bgr[i * 3 + 1];
      im.c2[i] = bgr[i * 3 + 2];
    }
  return im;
}

}  // namespace

// ---------------------------------------------------------------------------
// C API
// ---------------------------------------------------------------------------

extern "C" {

// Full pipeline.  cc_grd: 1 = TAD color+gradient, 0 = census.  Returns 0 on
// success.  out: uint8[2][h][w] scaled disparity maps (left, right).
int cspm_oracle_run(const uint8_t* left_bgr, const uint8_t* right_bgr,
                    int h, int w, int max_dis, int dis_scale, int cc_grd,
                    int use_cs, int use_pp, double reg_lambda, int max_iter,
                    int wnd_size, int scale_num, unsigned seed,
                    uint8_t* out) {
  if (h <= 0 || w <= 0 || max_dis < 1) return 1;
  Params p{h, w, max_dis, dis_scale, max_iter, wnd_size,
           use_pp != 0, seed};

  PlaneCost pc;
  pc.wnd = wnd_size;
  pc.max_dis = max_dis;
  const int levels = use_cs ? scale_num : 1;
  Img l0 = to_img(left_bgr, h, w), r0 = to_img(right_bgr, h, w);
  std::vector<Img> lp{l0}, rp{r0};
  for (int s = 1; s < levels; ++s) {
    lp.push_back(pyr_down(lp.back()));
    rp.push_back(pyr_down(rp.back()));
  }
  int md = max_dis;
  for (int s = 0; s < levels; ++s, md /= 2) {
    for (int v = 0; v < 2; ++v) {
      Volume vol;
      if (cc_grd)
        build_grd(lp[s], rp[s], md, v == 1, &vol);
      else
        build_census(lp[s], rp[s], md, v == 1, &vol);
      vol.maxc = *std::max_element(vol.v.begin(), vol.v.end());
      pc.imgs[v].push_back(v == 0 ? lp[s] : rp[s]);
      pc.vols[v].push_back(std::move(vol));
    }
  }
  pc.wgts = use_cs ? scale_weights(levels, reg_lambda)
                   : std::vector<double>{1.0};

  State st;
  init_random(p, pc, &st);
  for (int it = 0; it < max_iter; ++it) {
    spatial_prop(p, pc, &st, it);
    view_prop(p, pc, &st);
    refine(p, pc, &st, it);
  }
  plane_to_disp(p, st, out);
  if (p.use_pp) post_process(p, pc, st, out);
  return 0;
}

// Cost-volume-only entry (for op-level cross-checks).
int cspm_oracle_volume(const uint8_t* left_bgr, const uint8_t* right_bgr,
                       int h, int w, int max_dis, int cc_grd, int right,
                       double* out) {
  Img l = to_img(left_bgr, h, w), r = to_img(right_bgr, h, w);
  Volume vol;
  if (cc_grd)
    build_grd(l, r, max_dis, right != 0, &vol);
  else
    build_census(l, r, max_dis, right != 0, &vol);
  std::memcpy(out, vol.v.data(), vol.v.size() * sizeof(double));
  return 0;
}

}  // extern "C"
