// OpenMP C++ baseline for the RB-PHD SLAM benchmark workload.
//
// Measures the reference architecture's throughput on this host: double
// precision, scalar per-landmark EKF loops, OpenMP `parallel for` over
// particles (the reference's only parallelism — RBPHDFilter.hpp:469-520),
// same phases and workload as bench.py (3000 steps, 200 particles, 50
// landmarks, P_D 0.99, clutter 1e-4 — cfg/rbphdslam2dSim.xml).
//
// This is a fresh implementation of the same algorithm (see SURVEY.md), not a
// copy of the reference (which needs Boost+Eigen, unavailable here).  Phases:
// predict (pose sampling + landmark cov growth), birth from unused
// measurements, batched-per-particle EKF map update with the nM x nZ weight
// table, importance weighting (eval points, intensity products, subset-sum
// RFS likelihood — the same exact algorithm the JAX filter uses), O(M^2)
// greedy merge, prune, ESS-gated systematic resampling with deep map copies.
//
// Output: one JSON line {"timesteps_per_sec": X}.

#include <algorithm>
#include <array>
#include <cmath>
#include <cstdio>
#include <cstring>
#include <random>
#include <vector>
#ifdef _OPENMP
#include <omp.h>
#endif

static constexpr int T = 3000;
static constexpr int P = 200;
static constexpr int NLM = 50;
static constexpr int MAP_CAP = 256;
static constexpr int ZCAP = 40;
static constexpr int EVAL_PTS = 15;
static constexpr int ZDP = 10;

static constexpr double DT = 0.1;
static constexpr double RMAX = 2.5, RMIN = 0.5, RBUF = 0.05;
static constexpr double PD = 0.99, CLUTTER = 1e-4;
static constexpr double VARZR = 0.0005 * 10.0, VARZB = 0.00005 * 10.0;
static constexpr double VARD = 0.002;
static constexpr double QLM = 0.0002 * DT * DT;
static constexpr double BIRTH_W = 0.01, PRUNE_T = 0.01;
static constexpr double MERGE_T2 = 0.25, MERGE_INFL = 1.5;
static constexpr double MD_NEW2 = 9.0, MD_WEIGHT2 = 9.0;
static constexpr double GATE_R = 1.0, GATE_B = 0.2;
static constexpr double MIN_EVAL_W = 0.75;

struct LM { double x, y, p00, p01, p11, w, wprev; };
struct Particle {
  double x, y, th, logw;
  std::vector<LM> map;
  std::vector<int> unused;  // indices into last z set
};

static inline double wrap(double a) {
  while (a > M_PI) a -= 2 * M_PI;
  while (a < -M_PI) a += 2 * M_PI;
  return a;
}

int main(int argc, char** argv) {
  // ---------------- simulate data (same generator shape as io/sim2d.py)
  std::mt19937_64 rng(1);
  std::uniform_real_distribution<double> U(0.0, 1.0);
  std::normal_distribution<double> N(0.0, 1.0);

  std::vector<std::array<double, 3>> gt(T), odo(T);
  std::vector<std::array<double, 3>> gti(T);
  int seg = 0; double u[3] = {0, 0, 0};
  for (int k = 1; k < T; k++) {
    if (k <= 50) { u[0] = u[1] = u[2] = 0; }
    else if (k >= (double)T / 20 * seg) {
      seg++;
      double dx = U(rng) * 0.3 * DT;
      while (dx < 0.1 * DT) dx = U(rng) * 0.3 * DT;
      u[0] = dx; u[1] = 0.0; u[2] = (U(rng) * 1.0 - 0.5) * DT;
    }
    gti[k] = {u[0], u[1], u[2]};
    double c = cos(gt[k - 1][2]), s = sin(gt[k - 1][2]);
    gt[k] = {gt[k - 1][0] + c * u[0] - s * u[1],
             gt[k - 1][1] + s * u[0] + c * u[1],
             wrap(gt[k - 1][2] + u[2])};
  }
  double sq = sqrt(VARD) * DT;
  for (int k = 1; k < T; k++)
    odo[k] = {gti[k][0] + sq * N(rng), gti[k][1] + sq * N(rng),
              gti[k][2] + sq * N(rng)};

  std::vector<std::array<double, 2>> lms;
  int created = 0;
  for (int k = 1; k < T; k++)
    if (k >= (double)T / NLM * created && created < NLM) {
      double r = U(rng) * RMAX, b = U(rng) * 2 * M_PI;
      lms.push_back({gt[k][0] + r * cos(gt[k][2] + b),
                     gt[k][1] + r * sin(gt[k][2] + b)});
      created++;
    }

  std::vector<std::vector<std::array<double, 2>>> zs(T);
  double sr = sqrt(0.0005), sb = sqrt(0.00005);
  double mean_clutter = CLUTTER * 2 * M_PI * (RMAX - RMIN);
  std::poisson_distribution<int> PZ(mean_clutter);
  for (int k = 1; k < T; k++) {
    for (auto& lm : lms) {
      double dx = lm[0] - gt[k][0], dy = lm[1] - gt[k][1];
      double r = hypot(dx, dy);
      if (r < RMIN || r > RMAX) continue;
      double zr = r + sr * N(rng), zb = wrap(atan2(dy, dx) - gt[k][2] + sb * N(rng));
      if (zr >= RMIN && zr <= RMAX && U(rng) <= PD)
        zs[k].push_back({zr, zb});
    }
    int nc = PZ(rng);
    for (int i = 0; i < nc; i++) {
      double r = U(rng) * RMAX;
      while (r < RMIN) r = U(rng) * RMAX;
      zs[k].push_back({r, U(rng) * 2 * M_PI - M_PI});
    }
    if ((int)zs[k].size() > ZCAP) zs[k].resize(ZCAP);
  }

  // optional: dump the generated sim data so the JAX filter can run on
  // IDENTICAL inputs (scripts/sim_accuracy_check.py) — isolates filter
  // quality from data-generation RNG differences
  if (argc > 1 && strcmp(argv[1], "--dump") == 0 && argc > 2) {
    char path[512];
    snprintf(path, sizeof path, "%s/gt_odo.txt", argv[2]);
    FILE* f = fopen(path, "w");
    for (int k = 0; k < T; k++)
      fprintf(f, "%.17g %.17g %.17g %.17g %.17g %.17g\n",
              gt[k][0], gt[k][1], gt[k][2], odo[k][0], odo[k][1], odo[k][2]);
    fclose(f);
    snprintf(path, sizeof path, "%s/z.txt", argv[2]);
    f = fopen(path, "w");
    for (int k = 0; k < T; k++)
      for (auto& z : zs[k])
        fprintf(f, "%d %.17g %.17g\n", k, z[0], z[1]);
    fclose(f);
  }

  // ---------------- filter
  std::vector<Particle> parts(P);
  for (auto& p : parts) { p.x = p.y = p.th = 0; p.logw = 0; p.map.reserve(MAP_CAP + 64); }
  int nthreads = 1;
#ifdef _OPENMP
  nthreads = omp_get_max_threads();
#endif
  std::vector<std::mt19937_64> trngs;
  for (int i = 0; i < nthreads; i++) trngs.emplace_back(1000 + i);

  int n_upd = 0;
  double t_start = 0;
#ifdef _OPENMP
  t_start = omp_get_wtime();
#else
  t_start = (double)clock() / CLOCKS_PER_SEC;
#endif

  std::vector<std::array<double, 2>> lastz;
  std::vector<double> errs;
  for (int k = 1; k < T; k++) {
    auto& Z = zs[k];
    int nZ = (int)Z.size();

    // ---- predict: births + propagate + landmark cov growth
#pragma omp parallel for schedule(static)
    for (int i = 0; i < P; i++) {
      int tid = 0;
#ifdef _OPENMP
      tid = omp_get_thread_num();
#endif
      auto& pr = parts[i];
      std::normal_distribution<double> n01(0.0, 1.0);
      // births from unused measurements of the previous update
      for (int zi : pr.unused) {
        if ((int)pr.map.size() >= MAP_CAP) break;
        double a = pr.th + lastz[zi][1], r = lastz[zi][0];
        double c = cos(a), s = sin(a);
        // cov = Hinv R Hinv^T
        LM lm;
        lm.x = pr.x + r * c; lm.y = pr.y + r * s;
        lm.p00 = c * c * VARZR + r * r * s * s * VARZB;
        lm.p01 = c * s * VARZR - r * r * s * c * VARZB;
        lm.p11 = s * s * VARZR + r * r * c * c * VARZB;
        lm.w = BIRTH_W; lm.wprev = 0;
        pr.map.push_back(lm);
      }
      pr.unused.clear();
      // propagate
      double c = cos(pr.th), s = sin(pr.th);
      double ux = odo[k][0], uy = odo[k][1], uth = odo[k][2];
      double sqp = sqrt(VARD * 1.5) * DT;
      pr.x += c * ux - s * uy + sqp * n01(trngs[tid]);
      pr.y += s * ux + c * uy + sqp * n01(trngs[tid]);
      pr.th = wrap(pr.th + uth + sqp * n01(trngs[tid]));
      for (auto& lm : pr.map) { lm.p00 += QLM; lm.p11 += QLM; }
    }
    // groundtruth lock-in
    if (k <= 100)
      for (auto& pr : parts) { pr.x = gt[k][0]; pr.y = gt[k][1]; pr.th = gt[k][2]; }

    if (nZ == 0) continue;
    n_upd++;

    // ---- update
#pragma omp parallel for schedule(static)
    for (int i = 0; i < P; i++) {
      auto& pr = parts[i];
      int nM = (int)pr.map.size();
      if (nM == 0) {
        for (int z = 0; z < nZ; z++) pr.unused.push_back(z);
        continue;
      }
      std::vector<double> wtab(nM * nZ, 0.0);
      std::vector<LM> news;
      std::vector<double> pd(nM), close(nM);
      double sum_before = 0, sum_after = 0;
      for (int m = 0; m < nM; m++) {
        LM& lm = pr.map[m];
        double dx = lm.x - pr.x, dy = lm.y - pr.y;
        double r2 = dx * dx + dy * dy, r = sqrt(r2);
        bool inside = r >= RMIN && r <= RMAX;
        bool cl = inside ? (r >= RMAX - RBUF || r <= RMIN + RBUF)
                         : (r <= RMAX + RBUF && r >= RMIN - RBUF);
        pd[m] = inside ? PD : 0.0;
        close[m] = cl;
        if (cl) pd[m] = 1.0;
        if (pd[m] == 0) continue;
        // EKF shared across z
        double h00 = dx / r, h01 = dy / r, h10 = -dy / r2, h11 = dx / r2;
        double zer = r, zeb = wrap(atan2(dy, dx) - pr.th);
        // S = H P H^T + R
        double ph00 = h00 * lm.p00 + h01 * lm.p01, ph01 = h00 * lm.p01 + h01 * lm.p11;
        double ph10 = h10 * lm.p00 + h11 * lm.p01, ph11 = h10 * lm.p01 + h11 * lm.p11;
        double s00 = ph00 * h00 + ph01 * h01 + VARZR;
        double s01 = ph00 * h10 + ph01 * h11;
        double s11 = ph10 * h10 + ph11 * h11 + VARZB;
        double det = s00 * s11 - s01 * s01;
        double i00 = s11 / det, i01 = -s01 / det, i11 = s00 / det;
        // K = P H^T Sinv
        double pht00 = lm.p00 * h00 + lm.p01 * h01, pht01 = lm.p00 * h10 + lm.p01 * h11;
        double pht10 = lm.p01 * h00 + lm.p11 * h01, pht11 = lm.p01 * h10 + lm.p11 * h11;
        double k00 = pht00 * i00 + pht01 * i01, k01 = pht00 * i01 + pht01 * i11;
        double k10 = pht10 * i00 + pht11 * i01, k11 = pht10 * i01 + pht11 * i11;
        // P+ = (I-KH)P
        double a00 = 1 - (k00 * h00 + k01 * h10), a01 = -(k00 * h01 + k01 * h11);
        double a10 = -(k10 * h00 + k11 * h10), a11 = 1 - (k10 * h01 + k11 * h11);
        double q00 = a00 * lm.p00 + a01 * lm.p01, q01 = a00 * lm.p01 + a01 * lm.p11;
        double q11 = a10 * lm.p01 + a11 * lm.p11;
        double norm = sqrt(4 * M_PI * M_PI * det);
        double w_km = lm.w;
        for (int z = 0; z < nZ; z++) {
          double ir = Z[z][0] - zer, ib = wrap(Z[z][1] - zeb);
          if (fabs(ir) > GATE_R || fabs(ib) > GATE_B) continue;
          double md2 = ir * (i00 * ir + i01 * ib) + ib * (i01 * ir + i11 * ib);
          if (md2 > MD_NEW2) continue;
          double lik = exp(-0.5 * md2) / norm;
          if (lik <= 0) continue;
          wtab[m * nZ + z] = pd[m] * w_km * lik;
          LM nl;
          nl.x = lm.x + k00 * ir + k01 * ib;
          nl.y = lm.y + k10 * ir + k11 * ib;
          nl.p00 = q00; nl.p01 = q01; nl.p11 = q11;
          nl.w = 0; nl.wprev = 0;
          news.push_back(nl);  // weight filled after normalization
        }
      }
      // column normalization
      {
        int ni = 0;
        std::vector<int> news_pos(nM * nZ, -1);
        for (int m = 0; m < nM; m++)
          for (int z = 0; z < nZ; z++)
            if (wtab[m * nZ + z] > 0) news_pos[m * nZ + z] = ni++;
        for (int z = 0; z < nZ; z++) {
          double sum = CLUTTER;
          for (int m = 0; m < nM; m++) sum += wtab[m * nZ + z];
          for (int m = 0; m < nM; m++) {
            wtab[m * nZ + z] /= sum;
            int np = news_pos[m * nZ + z];
            if (np >= 0) news[np].w = wtab[m * nZ + z];
          }
        }
      }
      // missed detection + w_prev
      for (int m = 0; m < nM; m++) {
        LM& lm = pr.map[m];
        double w_km = lm.w;
        double wk = (1 - pd[m]) * w_km;
        if (close[m] && w_km > BIRTH_W) {
          double rs = 0;
          for (int z = 0; z < nZ; z++) rs += wtab[m * nZ + z];
          double delta = pd[m] * w_km - rs;
          if (delta > 0) wk = std::min(wk + delta, 1.0);
        }
        lm.wprev = w_km; lm.w = wk;
      }
      // unused measurements
      for (int z = 0; z < nZ; z++) {
        bool used = false;
        for (int m = 0; m < nM; m++) if (wtab[m * nZ + z] > 0) { used = true; break; }
        if (!used) pr.unused.push_back(z);
      }
      // append new gaussians
      for (auto& nl : news)
        if (nl.w > 0 && (int)pr.map.size() < MAP_CAP + 64) pr.map.push_back(nl);

      // ---- importance weighting
      int nMf = (int)pr.map.size();
      // eval points: top-EVAL_PTS by weight among w>=0.75 & in range
      std::vector<int> order(nMf);
      for (int m = 0; m < nMf; m++) order[m] = m;
      std::sort(order.begin(), order.end(), [&](int a, int b) {
        return pr.map[a].w > pr.map[b].w;
      });
      std::vector<int> ev; std::vector<double> evpd;
      for (int oi = 0; oi < nMf && (int)ev.size() < EVAL_PTS; oi++) {
        LM& lm = pr.map[order[oi]];
        if (lm.w < MIN_EVAL_W) break;
        double r = hypot(lm.x - pr.x, lm.y - pr.y);
        if (r >= RMIN && r <= RMAX) { ev.push_back(order[oi]); evpd.push_back(PD); }
      }
      for (auto& lm : pr.map) { sum_before += lm.wprev; sum_after += lm.w; }
      if (ev.empty()) { pr.logw = -700; continue; }
      double log_ratio = 0;
      for (size_t e = 0; e < ev.size(); e++) {
        LM& ep = pr.map[ev[e]];
        double ib = 1e-300, ia = 1e-300;
        for (auto& lm : pr.map) {
          double det = lm.p00 * lm.p11 - lm.p01 * lm.p01;
          double dx = ep.x - lm.x, dy = ep.y - lm.y;
          double md2 = (dx * (lm.p11 * dx - lm.p01 * dy) + dy * (lm.p00 * dy - lm.p01 * dx)) / det;
          double lik = exp(-0.5 * md2) / sqrt(4 * M_PI * M_PI * det);
          if (std::isfinite(lik)) { ib += lm.wprev * lik; ia += lm.w * lik; }
        }
        log_ratio += log(ib) - log(ia);
      }
      // RFS likelihood: subset-sum DP over <=ZDP supported columns
      int nE = (int)ev.size();
      std::vector<double> L(nE * nZ, 0.0);
      for (int e = 0; e < nE; e++) {
        LM& ep = pr.map[ev[e]];
        double dx = ep.x - pr.x, dy = ep.y - pr.y;
        double r = hypot(dx, dy), zer = r, zeb = wrap(atan2(dy, dx) - pr.th);
        double det = VARZR * VARZB;
        for (int z = 0; z < nZ; z++) {
          double ir = Z[z][0] - zer, ibv = wrap(Z[z][1] - zeb);
          double md2 = ir * ir / VARZR + ibv * ibv / VARZB;
          if (md2 <= MD_WEIGHT2)
            L[e * nZ + z] = exp(-0.5 * md2) / sqrt(4 * M_PI * M_PI * det) * evpd[e];
        }
      }
      // select supported columns
      std::vector<int> cols;
      for (int z = 0; z < nZ; z++) {
        double mx = 0;
        for (int e = 0; e < nE; e++) mx = std::max(mx, L[e * nZ + z]);
        if (mx > 0) cols.push_back(z);
      }
      if ((int)cols.size() > ZDP) {
        std::sort(cols.begin(), cols.end(), [&](int a, int b) {
          double ma = 0, mb = 0;
          for (int e = 0; e < nE; e++) { ma = std::max(ma, L[e * nZ + a]); mb = std::max(mb, L[e * nZ + b]); }
          return ma > mb;
        });
        cols.resize(ZDP);
      }
      // columns outside the DP contribute their clutter factor
      double log_extra = 0;
      {
        std::vector<bool> indp(nZ, false);
        for (int c : cols) indp[c] = true;
        for (int z = 0; z < nZ; z++) if (!indp[z]) log_extra += log(CLUTTER);
      }
      int nC = (int)cols.size();
      std::vector<double> dp((size_t)1 << nC, 0.0);
      dp[0] = 1.0;
      double log_scale = 0;
      for (int e = 0; e < nE; e++) {
        bool sup = false;
        for (int c = 0; c < nC; c++) if (L[e * nZ + cols[c]] > 0) sup = true;
        double miss = sup ? (1 - evpd[e]) : evpd[e];
        double amax = miss;
        for (int c = 0; c < nC; c++) amax = std::max(amax, L[e * nZ + cols[c]]);
        log_scale += log(amax);
        std::vector<double> nd((size_t)1 << nC);
        for (size_t S = 0; S < ((size_t)1 << nC); S++) {
          double v = dp[S] * (miss / amax);
          for (int c = 0; c < nC; c++)
            if (S & ((size_t)1 << c))
              v += dp[S ^ ((size_t)1 << c)] * (L[e * nZ + cols[c]] / amax);
          nd[S] = v;
        }
        dp.swap(nd);
      }
      double total = 0;
      for (size_t S = 0; S < ((size_t)1 << nC); S++) {
        double w = dp[S];
        for (int c = 0; c < nC; c++)
          if (!(S & ((size_t)1 << c))) w *= CLUTTER;
        total += w;
      }
      double log_ci = log(CLUTTER * 2 * M_PI * (RMAX - RMIN));
      double log_rfs = log(std::max(total, 1e-300)) + log_scale + log_extra - log_ci;
      pr.logw += log_rfs + log_ratio + (sum_after - sum_before);

      // ---- merge (greedy O(M^2)) + prune
      for (int a = 0; a < (int)pr.map.size(); a++) {
        if (pr.map[a].w < 0) continue;
        for (int b = a + 1; b < (int)pr.map.size(); b++) {
          if (pr.map[b].w < 0) continue;
          LM &A = pr.map[a], &B = pr.map[b];
          double dx = B.x - A.x, dy = B.y - A.y;
          double detA = A.p00 * A.p11 - A.p01 * A.p01;
          double md2 = (dx * (A.p11 * dx - A.p01 * dy) + dy * (A.p00 * dy - A.p01 * dx)) / detA;
          if (md2 > MERGE_T2) {
            double detB = B.p00 * B.p11 - B.p01 * B.p01;
            double md2b = (dx * (B.p11 * dx - B.p01 * dy) + dy * (B.p00 * dy - B.p01 * dx)) / detB;
            if (md2b > MERGE_T2) continue;
          }
          double wm = A.w + B.w;
          if (wm == 0) continue;
          double xm = (A.x * A.w + B.x * B.w) / wm, ym = (A.y * A.w + B.y * B.w) / wm;
          double d1x = xm - A.x, d1y = ym - A.y, d2x = xm - B.x, d2y = ym - B.y;
          A.p00 = (A.w * (A.p00 + MERGE_INFL * d1x * d1x) + B.w * (B.p00 + MERGE_INFL * d2x * d2x)) / wm;
          A.p01 = (A.w * (A.p01 + MERGE_INFL * d1x * d1y) + B.w * (B.p01 + MERGE_INFL * d2x * d2y)) / wm;
          A.p11 = (A.w * (A.p11 + MERGE_INFL * d1y * d1y) + B.w * (B.p11 + MERGE_INFL * d2y * d2y)) / wm;
          A.x = xm; A.y = ym; A.w = wm; A.wprev = 0;
          B.w = -1;  // mark dead
        }
      }
      pr.map.erase(std::remove_if(pr.map.begin(), pr.map.end(),
                                  [](const LM& l) { return l.w < PRUNE_T; }),
                   pr.map.end());
      if ((int)pr.map.size() > MAP_CAP) {
        std::sort(pr.map.begin(), pr.map.end(),
                  [](const LM& a, const LM& b) { return a.w > b.w; });
        pr.map.resize(MAP_CAP);
      }
    }

    // ---- resample (serial, like the reference)
    lastz = Z;
    if (n_upd >= 2) {
      double mx = -1e300;
      for (auto& pr : parts) mx = std::max(mx, pr.logw);
      double sum = 0;
      for (auto& pr : parts) sum += exp(pr.logw - mx);
      double ess_den = 0;
      for (auto& pr : parts) {
        double w = exp(pr.logw - mx) / sum;
        ess_den += w * w;
      }
      if (1.0 / ess_den <= P / 2.0) {
        std::vector<double> cum(P);
        double c = 0;
        for (int i = 0; i < P; i++) { c += exp(parts[i].logw - mx) / sum; cum[i] = c; }
        double u0 = U(rng) / P;
        std::vector<Particle> newp(P);
        int idx = 0;
        for (int i = 0; i < P; i++) {
          double pt = u0 + (double)i / P;
          while (idx < P - 1 && cum[idx] < pt) idx++;
          newp[i] = parts[idx];  // deep copy incl. map
          newp[i].logw = 0;
        }
        parts.swap(newp);
        n_upd = 0;
      } else {
        double lse = mx + log(sum);
        for (auto& pr : parts) pr.logw -= lse;
      }
    }

    // best-particle position error (same metric as bench.py: median over
    // steps >= 150 of ||best_pose - gt||)
    if (k >= 150) {
      int best = 0;
      for (int i = 1; i < P; i++)
        if (parts[i].logw > parts[best].logw) best = i;
      double ex = parts[best].x - gt[k][0], ey = parts[best].y - gt[k][1];
      errs.push_back(sqrt(ex * ex + ey * ey));
    }
  }

  double t_end = 0;
#ifdef _OPENMP
  t_end = omp_get_wtime();
#else
  t_end = (double)clock() / CLOCKS_PER_SEC;
#endif
  double wall = t_end - t_start;
  std::sort(errs.begin(), errs.end());
  double med_err = errs.empty() ? 0.0 : errs[errs.size() / 2];
  size_t tot = 0;
  for (auto& pr : parts) tot += pr.map.size();
  fprintf(stderr, "wall=%.2fs threads=%d avg_map=%.1f\n", wall, nthreads,
          (double)tot / P);
  printf("{\"timesteps_per_sec\": %.2f, \"median_pose_err_m\": %.4f}\n",
         (T - 1) / wall, med_err);
  return 0;
}
