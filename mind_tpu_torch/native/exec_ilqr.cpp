// Native float64 tree-iLQR for the execution re-solve (the port's own copy
// of mind_tpu/native/exec_ilqr.cpp; the code is unchanged).
//
// The executed control of a plan comes from a float64 two-phase re-solve of
// the winning scenario tree (TrajTreeConfig.exec_resolve_mode="native").
// On the card that solve is launch-bound: a batch of one tree costs what the
// six-tree batch costs. Here it runs as a few milliseconds of native float64
// on the host CPU, as a C++ twin of the JAX package's float64 numpy mirror
// (mind_tpu/parity/host_ilqr.py), while the float32 pipeline stays on the
// card.
//
// Semantics are the reference solver's, matched operation-for-operation with
// host_ilqr.py (itself certified against reference planners/ilqr/
// solver.py:80-240 — recursive tree rollout, leaf-to-root Riccati with the
// child V_x/V_xx sum of solver.py:349-350, sequential first-accept
// backtracking over alpha = 1.1**(-i^2), Levenberg-Marquardt mu/delta
// schedule of solver.py:40-49,153-158) and the reference potential stack
// (planners/ilqr/potential.py, cost.py:326-446).
//
// Built as a plain shared library with a C interface; the ctypes wrapper
// lives in mind_tpu_torch/native/__init__.py.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int NX = 6;  // state: [px, py, v, q(yaw), a, steer]
constexpr int NU = 2;  // control: [da, ds]

// ---------------------------------------------------------------------------
// phase cost parameters (flat layout shared with the Python wrapper)
// ---------------------------------------------------------------------------
struct PhaseParams {
  double field_offset[2];
  double res;
  int grid_n;
  double w_tgt;
  double w_ego, w_ego_cov_offset;
  double w_exo, w_exo_cov_offset, w_exo_cost_offset;
  double w_des_state[6], des_state[6];
  double w_state_con[6], state_lb[6], state_ub[6];
  double w_ctrl[2];

  static PhaseParams unpack(const double* p) {
    PhaseParams o;
    o.field_offset[0] = p[0];
    o.field_offset[1] = p[1];
    o.res = p[2];
    o.grid_n = static_cast<int>(p[3]);
    o.w_tgt = p[4];
    o.w_ego = p[5];
    o.w_ego_cov_offset = p[6];
    o.w_exo = p[7];
    o.w_exo_cov_offset = p[8];
    o.w_exo_cost_offset = p[9];
    for (int i = 0; i < 6; ++i) {
      o.w_des_state[i] = p[10 + i];
      o.des_state[i] = p[16 + i];
      o.w_state_con[i] = p[22 + i];
      o.state_lb[i] = p[28 + i];
      o.state_ub[i] = p[34 + i];
    }
    o.w_ctrl[0] = p[40];
    o.w_ctrl[1] = p[41];
    return o;
  }
};

struct Problem {
  int n;                      // real cost nodes
  const int32_t* parents;     // [n], -1 = child of root state x0
  const double* prob;         // [n]
  const double* ego_mean;     // [n,2]
  const double* ego_cov;      // [n]
  int n_exo;
  const double* exo_mean;     // [n,n_exo,2]
  const double* exo_cov;      // [n,n_exo]
  const uint8_t* exo_mask;    // [n,n_exo]
  const double* tgt_pts;      // [n_tgt,2] cost-field target lane
  int n_tgt;
  double dt, wb;
};

// ---------------------------------------------------------------------------
// cost model (host_ilqr.py:69-205, reference potential.py / cost.py)
// ---------------------------------------------------------------------------

// min point-to-segment distance over the target lane (host_ilqr.py:69-75)
double point_segments_dist(const double px, const double py,
                           const double* lane, int n_pts) {
  double best = 1e300;
  for (int i = 0; i + 1 < n_pts; ++i) {
    const double ax = lane[2 * i], ay = lane[2 * i + 1];
    double sx = lane[2 * i + 2] - ax, sy = lane[2 * i + 3] - ay;
    double len_sq = sx * sx + sy * sy;
    if (!(len_sq > 0.0)) len_sq = 1.0;
    double t = ((px - ax) * sx + (py - ay) * sy) / len_sq;
    t = t < 0.0 ? 0.0 : (t > 1.0 ? 1.0 : t);
    const double dx = px - (ax + t * sx), dy = py - (ay + t * sy);
    const double d = std::sqrt(dx * dx + dy * dy);
    if (d < best) best = d;
  }
  return best;
}

// raw cost-field value at one grid-cell center (host_ilqr.py:78-95,
// reference trajectory_tree.py:80-106)
double cell_value(const Problem& pb, const PhaseParams& p, int node,
                  double cx, double cy) {
  const double d_tgt = point_segments_dist(cx, cy, pb.tgt_pts, pb.n_tgt);
  double val = p.w_tgt * pb.prob[node] * d_tgt * d_tgt;

  if (p.w_ego != 0.0) {
    const double ex = cx - pb.ego_mean[2 * node];
    const double ey = cy - pb.ego_mean[2 * node + 1];
    const double ego_d = std::sqrt(ex * ex + ey * ey);
    const double f = ego_d - (pb.ego_cov[node] + p.w_ego_cov_offset);
    if (f > 0.0) val += p.w_ego * f;
  }
  if (p.w_exo != 0.0 && pb.n_exo > 0) {
    double acc = 0.0;
    const double* em = pb.exo_mean + (size_t)node * pb.n_exo * 2;
    const double* ec = pb.exo_cov + (size_t)node * pb.n_exo;
    const uint8_t* msk = pb.exo_mask + (size_t)node * pb.n_exo;
    for (int x = 0; x < pb.n_exo; ++x) {
      if (!msk[x]) continue;
      const double dx = cx - em[2 * x], dy = cy - em[2 * x + 1];
      const double d = std::sqrt(dx * dx + dy * dy);
      double f = (ec[x] + p.w_exo_cov_offset) - d;
      if (f > 0.0) acc += f + p.w_exo_cost_offset;
    }
    val += p.w_exo * acc;
  }
  return val;
}

// memo of raw cell values per (node, cell): cell positions revisit across
// iLQR iterations/line-search rollouts, and a cell value costs ~n_tgt
// segment distances + n_exo discs. One open-addressed table per solve.
struct CellCache {
  std::vector<int64_t> key;  // node * grid_n^2 + iy * grid_n + ix ; -1 empty
  std::vector<double> val;
  int64_t grid_sq = 0;
  void reset(int n_nodes, int grid_n) {
    grid_sq = (int64_t)grid_n * grid_n;
    size_t cap = 1;
    while (cap < (size_t)n_nodes * 64) cap <<= 1;
    key.assign(cap, -1);
    val.assign(cap, 0.0);
  }
  double get(const Problem& pb, const PhaseParams& p, int node, int ix,
             int iy) {
    const int64_t k = (int64_t)node * grid_sq + (int64_t)iy * p.grid_n + ix;
    const size_t mask = key.size() - 1;
    size_t h = ((uint64_t)k * 0x9e3779b97f4a7c15ull) & mask;
    for (int probe = 0; probe < 8; ++probe, h = (h + 1) & mask) {
      if (key[h] == k) return val[h];
      if (key[h] < 0) {
        const double cx = p.field_offset[0] + p.res * ix;
        const double cy = p.field_offset[1] + p.res * iy;
        const double v = cell_value(pb, p, node, cx, cy);
        key[h] = k;
        val[h] = v;
        return v;
      }
    }
    const double cx = p.field_offset[0] + p.res * ix;
    const double cy = p.field_offset[1] + p.res * iy;
    return cell_value(pb, p, node, cx, cy);  // table saturated: recompute
  }
};

// smoothed biquadratic potential field: value, grad[2], hess[2][2]
// (host_ilqr.py:113-172, reference potential.py:72-264)
void field_eval(const Problem& pb, const PhaseParams& p, CellCache& cache,
                int node, const double* pos_in, double* f_val, double* f_grad,
                double* f_hess, bool want_derivs) {
  const double lo0 = p.field_offset[0], lo1 = p.field_offset[1];
  const double hi0 = lo0 + p.res * (p.grid_n - 1);
  const double hi1 = lo1 + p.res * (p.grid_n - 1);
  double pos0 = pos_in[0] < lo0 ? lo0 : (pos_in[0] > hi0 ? hi0 : pos_in[0]);
  double pos1 = pos_in[1] < lo1 ? lo1 : (pos_in[1] > hi1 ? hi1 : pos_in[1]);
  const double delta0 = pos_in[0] - pos0, delta1 = pos_in[1] - pos1;

  const double fx = (pos0 - lo0) / p.res;
  const double fy = (pos1 - lo1) / p.res;
  // numpy round = half-to-even; nearbyint follows the (default) FE_TONEAREST
  int x_idx = (int)std::nearbyint(fx);
  int y_idx = (int)std::nearbyint(fy);
  x_idx = x_idx < 0 ? 0 : (x_idx > p.grid_n - 1 ? p.grid_n - 1 : x_idx);
  y_idx = y_idx < 0 ? 0 : (y_idx > p.grid_n - 1 ? p.grid_n - 1 : y_idx);

  // local[r=y][c=x], zero outside the grid (ops/potential.py boundary rule)
  double local[3][3];
  for (int r = 0; r < 3; ++r) {
    const int iy = y_idx + r - 1;
    for (int c = 0; c < 3; ++c) {
      const int ix = x_idx + c - 1;
      local[r][c] = (ix >= 0 && ix < p.grid_n && iy >= 0 && iy < p.grid_n)
                        ? cache.get(pb, p, node, ix, iy)
                        : 0.0;
    }
  }

  // 2x2-mean smoothing (host_ilqr.py:98-110)
  double g[3][3];
  g[0][0] = (local[0][0] + local[0][1] + local[1][0] + local[1][1]) / 4;
  g[0][1] = (local[0][1] + local[1][1]) / 2;
  g[0][2] = (local[0][1] + local[0][2] + local[1][1] + local[1][2]) / 4;
  g[1][0] = (local[1][0] + local[1][1]) / 2;
  g[1][1] = local[1][1];
  g[1][2] = (local[1][1] + local[1][2]) / 2;
  g[2][0] = (local[1][0] + local[1][1] + local[2][0] + local[2][1]) / 4;
  g[2][1] = (local[1][1] + local[2][1]) / 2;
  g[2][2] = (local[1][1] + local[1][2] + local[2][1] + local[2][2]) / 4;

  const double ox = lo0 + p.res * x_idx, oy = lo1 + p.res * y_idx;
  const double u = (pos0 - ox) / p.res + 0.5;
  const double v = (pos1 - oy) / p.res + 0.5;

  const double bu[3] = {(1 - u) * (1 - u), 2 * (1 - u) * u, u * u};
  const double bv[3] = {(1 - v) * (1 - v), 2 * (1 - v) * v, v * v};
  const double dbu[3] = {-2 + 2 * u, 2 - 4 * u, 2 * u};
  const double dbv[3] = {-2 + 2 * v, 2 - 4 * v, 2 * v};
  const double ddb[3] = {2.0, -4.0, 2.0};

  // val = bv @ g @ bu etc. (row index = v, col index = u)
  auto quad = [&](const double* rv, const double* cu) {
    double acc = 0.0;
    for (int r = 0; r < 3; ++r) {
      double rowdot = 0.0;
      for (int c = 0; c < 3; ++c) rowdot += g[r][c] * cu[c];
      acc += rv[r] * rowdot;
    }
    return acc;
  };

  const double k = p.w_tgt * pb.prob[node];
  *f_val = quad(bv, bu) + k * (delta0 * delta0 + delta1 * delta1);
  if (!want_derivs) return;

  double gx = quad(bv, dbu) / p.res;
  double gy = quad(dbv, bu) / p.res;
  double hxx = quad(bv, ddb) / (p.res * p.res);
  double hyy = quad(ddb, bu) / (p.res * p.res);
  double hxy = quad(dbv, dbu) / (p.res * p.res);

  // convex pull-back outside the domain (ops/potential.py:171-182)
  const double out0 = delta0 != 0.0 ? 1.0 : 0.0;
  const double out1 = delta1 != 0.0 ? 1.0 : 0.0;
  const double in0 = 1.0 - out0, in1 = 1.0 - out1;
  f_grad[0] = gx * in0 + 2.0 * k * delta0;
  f_grad[1] = gy * in1 + 2.0 * k * delta1;
  f_hess[0] = hxx * in0 * in0 + 2.0 * k * out0;  // [0][0]
  f_hess[1] = hxy * in0 * in1;                   // [0][1]
  f_hess[2] = hxy * in1 * in0;                   // [1][0]
  f_hess[3] = hyy * in1 * in1 + 2.0 * k * out1;  // [1][1]
}

// value-only node cost (host_ilqr.py:175-205 value terms)
double node_cost_value(const Problem& pb, const PhaseParams& p,
                       CellCache& cache, int node, const double* x,
                       const double* u) {
  double f_val;
  field_eval(pb, p, cache, node, x, &f_val, nullptr, nullptr, false);
  const double prob = pb.prob[node];
  double sp = 0.0, sc = 0.0;
  for (int i = 0; i < 6; ++i) {
    const double diff = x[i] - p.des_state[i];
    sp += p.w_des_state[i] * prob * diff * diff;
    const double over = x[i] > p.state_ub[i] ? x[i] - p.state_ub[i] : 0.0;
    const double under = p.state_lb[i] > x[i] ? p.state_lb[i] - x[i] : 0.0;
    const double viol = over + under;
    sc += p.w_state_con[i] * prob * viol * viol;
  }
  const double cp = p.w_ctrl[0] * prob * u[0] * u[0] +
                    p.w_ctrl[1] * prob * u[1] * u[1];
  return f_val + sp + sc + cp;
}

// full cost expansion: l, l_x[6], l_u[2], l_xx[6][6] (diag + 2x2 field
// block), l_uu[2][2] diag (host_ilqr.py:175-205; l_ux == 0, cost.py:416-428)
void node_cost_expand(const Problem& pb, const PhaseParams& p,
                      CellCache& cache, int node, const double* x,
                      const double* u, double* l_x, double* l_u, double* l_xx,
                      double* l_uu) {
  double f_val, f_grad[2], f_hess[4];
  field_eval(pb, p, cache, node, x, &f_val, f_grad, f_hess, true);
  const double prob = pb.prob[node];
  std::memset(l_xx, 0, sizeof(double) * 36);
  for (int i = 0; i < 6; ++i) {
    const double w_des = p.w_des_state[i] * prob;
    const double diff = x[i] - p.des_state[i];
    const double w_con = p.w_state_con[i] * prob;
    const double over = x[i] > p.state_ub[i] ? x[i] - p.state_ub[i] : 0.0;
    const double under = p.state_lb[i] > x[i] ? p.state_lb[i] - x[i] : 0.0;
    const double viol = over + under;
    l_x[i] = 2.0 * w_des * diff + 2.0 * w_con * (over > 0.0 ? over : -under);
    l_xx[i * 6 + i] = 2.0 * w_des + (viol > 0.0 ? 2.0 * w_con : 0.0);
  }
  l_x[0] += f_grad[0];
  l_x[1] += f_grad[1];
  l_xx[0] += f_hess[0];
  l_xx[1] += f_hess[1];
  l_xx[6] += f_hess[2];
  l_xx[7] += f_hess[3];
  l_u[0] = 2.0 * p.w_ctrl[0] * prob * u[0];
  l_u[1] = 2.0 * p.w_ctrl[1] * prob * u[1];
  l_uu[0] = 2.0 * p.w_ctrl[0] * prob;
  l_uu[1] = 0.0;
  l_uu[2] = 0.0;
  l_uu[3] = 2.0 * p.w_ctrl[1] * prob;
}

// ---------------------------------------------------------------------------
// extended-bicycle dynamics (host_ilqr.py:212-241, reference
// trajectory_tree.py:149-177 / dynamics.py:245-285)
// ---------------------------------------------------------------------------
inline void bicycle_step(const double* x, const double* u, double dt,
                         double wb, double* out) {
  const double v = x[2], q = x[3], a = x[4], s = x[5];
  out[0] = x[0] + v * std::cos(q) * dt;
  out[1] = x[1] + v * std::sin(q) * dt;
  out[2] = v + a * dt;
  out[3] = q + v / wb * std::tan(s) * dt;
  out[4] = a + u[0] * dt;
  out[5] = s + u[1] * dt;
}

inline void bicycle_jacobians(const double* x, double dt, double wb,
                              double* f_x /*[36]*/, double* f_u /*[12]*/) {
  const double v = x[2], q = x[3], s = x[5];
  std::memset(f_x, 0, sizeof(double) * 36);
  for (int i = 0; i < 6; ++i) f_x[i * 6 + i] = 1.0;
  f_x[0 * 6 + 2] = std::cos(q) * dt;
  f_x[0 * 6 + 3] = -v * std::sin(q) * dt;
  f_x[1 * 6 + 2] = std::sin(q) * dt;
  f_x[1 * 6 + 3] = v * std::cos(q) * dt;
  f_x[2 * 6 + 4] = dt;
  f_x[3 * 6 + 2] = std::tan(s) / wb * dt;
  const double c = std::cos(s);
  f_x[3 * 6 + 5] = v / (wb * c * c) * dt;
  std::memset(f_u, 0, sizeof(double) * 12);
  f_u[4 * 2 + 0] = dt;
  f_u[5 * 2 + 1] = dt;
}

// ---------------------------------------------------------------------------
// tree iLQR (host_ilqr.py:290-390, reference solver.py:80-167)
// ---------------------------------------------------------------------------
struct SolveCfg {
  int max_iterations;
  double rel_tol;
  int n_line_search;
  double mu_max;
  // host_ilqr_solve defaults (mu_init/mu_min/delta_0)
  double mu_init = 1.0, mu_min = 1e-6, delta_0 = 2.0;
};

// 2x2 linear solve with partial pivoting (numpy.linalg.solve / LAPACK dgesv)
inline void solve2(const double A[4], const double b0, const double b1,
                   double* out) {
  if (std::fabs(A[2]) > std::fabs(A[0])) {
    // swap rows: [A2 A3 | b1], [A0 A1 | b0]
    const double m = A[0] / A[2];
    const double r = A[1] - m * A[3];
    out[1] = (b0 - m * b1) / r;
    out[0] = (b1 - A[3] * out[1]) / A[2];
  } else {
    const double m = A[2] / A[0];
    const double r = A[3] - m * A[1];
    out[1] = (b1 - m * b0) / r;
    out[0] = (b0 - A[1] * out[1]) / A[0];
  }
}

struct Workspace {
  std::vector<double> xs, us, xs_new, us_new;        // [n,6] / [n,2]
  std::vector<double> F_x, F_u;                      // [n,36] / [n,12]
  std::vector<double> L_x, L_u, L_xx, L_uu;          // [n,6]/[n,2]/[n,36]/[n,4]
  std::vector<double> V_x, V_xx, kff, Kfb;           // [n,6]/[n,36]/[n,2]/[n,12]
  void reset(int n) {
    xs.assign((size_t)n * 6, 0.0);
    us.assign((size_t)n * 2, 0.0);
    xs_new.assign((size_t)n * 6, 0.0);
    us_new.assign((size_t)n * 2, 0.0);
    F_x.assign((size_t)n * 36, 0.0);
    F_u.assign((size_t)n * 12, 0.0);
    L_x.assign((size_t)n * 6, 0.0);
    L_u.assign((size_t)n * 2, 0.0);
    L_xx.assign((size_t)n * 36, 0.0);
    L_uu.assign((size_t)n * 4, 0.0);
    V_x.assign((size_t)n * 6, 0.0);
    V_xx.assign((size_t)n * 36, 0.0);
    kff.assign((size_t)n * 2, 0.0);
    Kfb.assign((size_t)n * 12, 0.0);
  }
};

double tree_cost(const Problem& pb, const PhaseParams& p, CellCache& cache,
                 const double* xs, const double* us) {
  double J = 0.0;
  for (int i = 0; i < pb.n; ++i)
    J += node_cost_value(pb, p, cache, i, xs + i * 6, us + i * 2);
  return J;
}

int ilqr_solve(const Problem& pb, const PhaseParams& p, const double* x0,
               const double* us_init, const SolveCfg& cfg, Workspace& w,
               CellCache& cache, double* J_out, int* converged_out) {
  const int n = pb.n;
  w.reset(n);
  cache.reset(n, p.grid_n);
  std::memcpy(w.us.data(), us_init, sizeof(double) * n * 2);

  // open-loop rollout (host_ilqr.py:257-265)
  for (int i = 0; i < n; ++i) {
    const double* xp = pb.parents[i] < 0 ? x0 : w.xs.data() + pb.parents[i] * 6;
    bicycle_step(xp, w.us.data() + i * 2, pb.dt, pb.wb, w.xs.data() + i * 6);
  }
  double J_opt = tree_cost(pb, p, cache, w.xs.data(), w.us.data());

  std::vector<double> alphas(cfg.n_line_search);
  for (int i = 0; i < cfg.n_line_search; ++i)
    alphas[i] = std::pow(1.1, -double(i) * double(i));

  double mu = cfg.mu_init, delta = cfg.delta_0;
  bool accepted = true, converged = false;
  int it = 0;

  std::vector<std::vector<int>> children(n);
  for (int i = 0; i < n; ++i)
    if (pb.parents[i] >= 0) children[pb.parents[i]].push_back(i);

  for (it = 1; it <= cfg.max_iterations; ++it) {
    if (accepted) {
      for (int i = 0; i < n; ++i) {
        bicycle_jacobians(w.xs.data() + i * 6, pb.dt, pb.wb,
                          w.F_x.data() + i * 36, w.F_u.data() + i * 12);
        node_cost_expand(pb, p, cache, i, w.xs.data() + i * 6,
                         w.us.data() + i * 2, w.L_x.data() + i * 6,
                         w.L_u.data() + i * 2, w.L_xx.data() + i * 36,
                         w.L_uu.data() + i * 4);
      }
    }

    // backward pass, leaf -> root; children V summed into the parent
    // (host_ilqr.py:334-360, reference solver.py:332-373). Nodes are in
    // topological order (parent < child), so reverse index order visits all
    // children before their parent; child sums accumulate in ASCENDING child
    // order to reproduce the mirror's summation order bit-for-bit.
    bool pd_ok = true;
    for (int i = n - 1; i >= 0; --i) {
      double v_x[6] = {0, 0, 0, 0, 0, 0};
      double v_xx[36] = {0};
      for (int c : children[i]) {
        const double* cvx = w.V_x.data() + (size_t)c * 6;
        const double* cvxx = w.V_xx.data() + (size_t)c * 36;
        for (int a = 0; a < 6; ++a) v_x[a] += cvx[a];
        for (int a = 0; a < 36; ++a) v_xx[a] += cvxx[a];
      }
      const double* fx = w.F_x.data() + (size_t)i * 36;
      const double* fu = w.F_u.data() + (size_t)i * 12;

      double Q_x[6], Q_u[2], Q_xx[36], Q_ux[12], Q_uu[4];
      // Q_x = L_x + F_x^T v_x ; Q_u = L_u + F_u^T v_x
      for (int a = 0; a < 6; ++a) {
        double acc = 0.0;
        for (int b = 0; b < 6; ++b) acc += fx[b * 6 + a] * v_x[b];
        Q_x[a] = w.L_x[(size_t)i * 6 + a] + acc;
      }
      for (int a = 0; a < 2; ++a) {
        double acc = 0.0;
        for (int b = 0; b < 6; ++b) acc += fu[b * 2 + a] * v_x[b];
        Q_u[a] = w.L_u[(size_t)i * 2 + a] + acc;
      }
      // Q_xx = L_xx + F_x^T v_xx F_x (unregularized v_xx)
      double tmp[36];  // v_xx @ F_x
      for (int r = 0; r < 6; ++r)
        for (int c = 0; c < 6; ++c) {
          double acc = 0.0;
          for (int q = 0; q < 6; ++q) acc += v_xx[r * 6 + q] * fx[q * 6 + c];
          tmp[r * 6 + c] = acc;
        }
      for (int r = 0; r < 6; ++r)
        for (int c = 0; c < 6; ++c) {
          double acc = 0.0;
          for (int q = 0; q < 6; ++q) acc += fx[q * 6 + r] * tmp[q * 6 + c];
          Q_xx[r * 6 + c] = w.L_xx[(size_t)i * 36 + r * 6 + c] + acc;
        }
      // V_reg = v_xx + mu I ; Q_ux = F_u^T V_reg F_x ; Q_uu = L_uu + F_u^T V_reg F_u
      double vreg[36];
      std::memcpy(vreg, v_xx, sizeof(vreg));
      for (int d = 0; d < 6; ++d) vreg[d * 6 + d] += mu;
      double vf[36];  // V_reg @ F_x
      for (int r = 0; r < 6; ++r)
        for (int c = 0; c < 6; ++c) {
          double acc = 0.0;
          for (int q = 0; q < 6; ++q) acc += vreg[r * 6 + q] * fx[q * 6 + c];
          vf[r * 6 + c] = acc;
        }
      for (int r = 0; r < 2; ++r)
        for (int c = 0; c < 6; ++c) {
          double acc = 0.0;
          for (int q = 0; q < 6; ++q) acc += fu[q * 2 + r] * vf[q * 6 + c];
          Q_ux[r * 6 + c] = acc;
        }
      double vfu[12];  // V_reg @ F_u
      for (int r = 0; r < 6; ++r)
        for (int c = 0; c < 2; ++c) {
          double acc = 0.0;
          for (int q = 0; q < 6; ++q) acc += vreg[r * 6 + q] * fu[q * 2 + c];
          vfu[r * 2 + c] = acc;
        }
      for (int r = 0; r < 2; ++r)
        for (int c = 0; c < 2; ++c) {
          double acc = 0.0;
          for (int q = 0; q < 6; ++q) acc += fu[q * 2 + r] * vfu[q * 2 + c];
          Q_uu[r * 2 + c] = w.L_uu[(size_t)i * 4 + r * 2 + c] + acc;
        }
      if (!(Q_uu[0] > 0.0 && Q_uu[0] * Q_uu[3] - Q_uu[1] * Q_uu[2] > 0.0))
        pd_ok = false;

      double* k = w.kff.data() + (size_t)i * 2;
      double* K = w.Kfb.data() + (size_t)i * 12;
      solve2(Q_uu, Q_u[0], Q_u[1], k);
      k[0] = -k[0];
      k[1] = -k[1];
      for (int c = 0; c < 6; ++c) {
        double col[2];
        solve2(Q_uu, Q_ux[c], Q_ux[6 + c], col);
        K[c] = -col[0];
        K[6 + c] = -col[1];
      }
      // V_x = Q_x + K^T Q_uu k + K^T Q_u + Q_ux^T k
      double quu_k[2] = {Q_uu[0] * k[0] + Q_uu[1] * k[1],
                         Q_uu[2] * k[0] + Q_uu[3] * k[1]};
      double* Vx_i = w.V_x.data() + (size_t)i * 6;
      for (int a = 0; a < 6; ++a)
        Vx_i[a] = Q_x[a] + K[a] * quu_k[0] + K[6 + a] * quu_k[1] +
                  K[a] * Q_u[0] + K[6 + a] * Q_u[1] + Q_ux[a] * k[0] +
                  Q_ux[6 + a] * k[1];
      // vxx = Q_xx + K^T Q_uu K + K^T Q_ux + Q_ux^T K ; symmetrize
      double quu_K[12];  // Q_uu @ K
      for (int c = 0; c < 6; ++c) {
        quu_K[c] = Q_uu[0] * K[c] + Q_uu[1] * K[6 + c];
        quu_K[6 + c] = Q_uu[2] * K[c] + Q_uu[3] * K[6 + c];
      }
      double* Vxx_i = w.V_xx.data() + (size_t)i * 36;
      for (int r = 0; r < 6; ++r)
        for (int c = 0; c < 6; ++c) {
          const double m_rc = Q_xx[r * 6 + c] + K[r] * quu_K[c] +
                              K[6 + r] * quu_K[6 + c] + K[r] * Q_ux[c] +
                              K[6 + r] * Q_ux[6 + c] + Q_ux[r] * K[c] +
                              Q_ux[6 + r] * K[6 + c];
          Vxx_i[r * 6 + c] = m_rc;
        }
      for (int r = 0; r < 6; ++r)
        for (int c = r; c < 6; ++c) {
          const double s = 0.5 * (Vxx_i[r * 6 + c] + Vxx_i[c * 6 + r]);
          Vxx_i[r * 6 + c] = s;
          Vxx_i[c * 6 + r] = s;
        }
    }

    // sequential first-accept line search (host_ilqr.py:362-373,
    // reference solver.py:124-125,180-199)
    accepted = false;
    if (pd_ok) {
      for (int ai = 0; ai < cfg.n_line_search; ++ai) {
        const double alpha = alphas[ai];
        for (int i = 0; i < n; ++i) {
          const int par = pb.parents[i];
          const double* xp_new = par < 0 ? x0 : w.xs_new.data() + par * 6;
          const double* xp_nom = par < 0 ? x0 : w.xs.data() + par * 6;
          const double* K = w.Kfb.data() + (size_t)i * 12;
          double du0 = 0.0, du1 = 0.0;
          for (int a = 0; a < 6; ++a) {
            const double dx = xp_new[a] - xp_nom[a];
            du0 += K[a] * dx;
            du1 += K[6 + a] * dx;
          }
          w.us_new[i * 2] =
              w.us[i * 2] + alpha * w.kff[(size_t)i * 2] + du0;
          w.us_new[i * 2 + 1] =
              w.us[i * 2 + 1] + alpha * w.kff[(size_t)i * 2 + 1] + du1;
          bicycle_step(xp_new, w.us_new.data() + i * 2, pb.dt, pb.wb,
                       w.xs_new.data() + i * 6);
        }
        const double J_new =
            tree_cost(pb, p, cache, w.xs_new.data(), w.us_new.data());
        if (J_new < J_opt) {
          converged = std::fabs((J_opt - J_new) / J_opt) < cfg.rel_tol;
          std::swap(w.xs, w.xs_new);
          std::swap(w.us, w.us_new);
          J_opt = J_new;
          accepted = true;
          break;
        }
      }
    }

    // Levenberg-Marquardt schedule (host_ilqr.py:375-385,
    // reference solver.py:40-49,153-158,194-198)
    if (accepted) {
      delta = (delta < 1.0 ? delta : 1.0) / cfg.delta_0;
      mu *= delta;
      if (mu <= cfg.mu_min) mu = 0.0;
    } else {
      delta = (delta > 1.0 ? delta : 1.0) * cfg.delta_0;
      mu = std::max(cfg.mu_min, mu * delta);
      if (mu >= cfg.mu_max) break;
    }
    if (converged) break;
  }

  *J_out = J_opt;
  *converged_out = converged ? 1 : 0;
  return it > cfg.max_iterations ? cfg.max_iterations : it;
}

}  // namespace

extern "C" {

// Two-phase execution re-solve of one scenario tree: warm solve (target-lane
// field only) from zero controls, then the full solve from the warm controls
// (reference planner.py:174-178; trajectory_tree.py:two_phase_solve).
// Returns 0 on success. out_info = [J_full, warm_iters, full_iters,
// converged_full]. out_xs/out_us are [n,6]/[n,2]; executed control =
// out_xs[0][4:6] (planner.py:141-144).
int mind_exec_two_phase_solve(
    int n, const int32_t* parents, const double* prob, const double* ego_mean,
    const double* ego_cov, int n_exo, const double* exo_mean,
    const double* exo_cov, const uint8_t* exo_mask, const double* tgt_pts,
    int n_tgt, const double* x0, const double* warm_params_flat,
    const double* full_params_flat, double dt, double wb, int warm_max_iter,
    int full_max_iter, double rel_tol, int n_line_search, double mu_max,
    double* out_xs, double* out_us, double* out_info) {
  if (n <= 0) return 1;
  Problem pb{n,        parents,  prob,     ego_mean, ego_cov, n_exo,
             exo_mean, exo_cov,  exo_mask, tgt_pts,  n_tgt,   dt,
             wb};
  const PhaseParams warm = PhaseParams::unpack(warm_params_flat);
  const PhaseParams full = PhaseParams::unpack(full_params_flat);

  Workspace w;
  CellCache cache;
  std::vector<double> us0((size_t)n * 2, 0.0);
  double J = 0.0;
  int conv = 0;

  SolveCfg wcfg{warm_max_iter, rel_tol, n_line_search, mu_max};
  const int warm_iters =
      ilqr_solve(pb, warm, x0, us0.data(), wcfg, w, cache, &J, &conv);
  std::vector<double> us_warm(w.us);

  SolveCfg fcfg{full_max_iter, rel_tol, n_line_search, mu_max};
  const int full_iters =
      ilqr_solve(pb, full, x0, us_warm.data(), fcfg, w, cache, &J, &conv);

  std::memcpy(out_xs, w.xs.data(), sizeof(double) * n * 6);
  std::memcpy(out_us, w.us.data(), sizeof(double) * n * 2);
  out_info[0] = J;
  out_info[1] = warm_iters;
  out_info[2] = full_iters;
  out_info[3] = conv;
  return 0;
}

// Single-phase solve from caller-provided initial controls (the numpy
// mirror's host_ilqr_solve surface, for tests and the polish variant).
int mind_exec_ilqr_solve(int n, const int32_t* parents, const double* prob,
                         const double* ego_mean, const double* ego_cov,
                         int n_exo, const double* exo_mean,
                         const double* exo_cov, const uint8_t* exo_mask,
                         const double* tgt_pts, int n_tgt, const double* x0,
                         const double* us_init, const double* params_flat,
                         double dt, double wb, int max_iter, double rel_tol,
                         int n_line_search, double mu_max, double* out_xs,
                         double* out_us, double* out_info) {
  if (n <= 0) return 1;
  Problem pb{n,        parents,  prob,     ego_mean, ego_cov, n_exo,
             exo_mean, exo_cov,  exo_mask, tgt_pts,  n_tgt,   dt,
             wb};
  const PhaseParams p = PhaseParams::unpack(params_flat);
  Workspace w;
  CellCache cache;
  double J = 0.0;
  int conv = 0;
  SolveCfg cfg{max_iter, rel_tol, n_line_search, mu_max};
  const int iters = ilqr_solve(pb, p, x0, us_init, cfg, w, cache, &J, &conv);
  std::memcpy(out_xs, w.xs.data(), sizeof(double) * n * 6);
  std::memcpy(out_us, w.us.data(), sizeof(double) * n * 2);
  out_info[0] = J;
  out_info[1] = iters;
  out_info[2] = iters;
  out_info[3] = conv;
  return 0;
}

}  // extern "C"
