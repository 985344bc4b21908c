"""Plain float64 NumPy/SciPy references for the device ops.

Each function here is a straightforward, independent implementation of the
semantics of one op of the filters — loops and dense matrices in float64,
no plane layout, no one-hot tricks — so tests (on CPU, small shapes) and
``chip_smoke.py`` (on the GPU, bench widths) compare the compiled ops
against the same oracle.  Nothing here runs inside a filter.
"""

from __future__ import annotations

import heapq
from typing import NamedTuple

import numpy as np


def wrap(a):
    """Angle to [-pi, pi)."""
    return (a + np.pi) % (2 * np.pi) - np.pi


# ------------------------------------------------------------------- EKF
class EKFRef(NamedTuple):
    mean: np.ndarray    # (..., 2)    updated mean
    cov: np.ndarray     # (..., 2, 2) updated covariance (symmetrized)
    lik: np.ndarray     # (...)       N(z; z_exp, S)
    md2: np.ndarray     # (...)       squared Mahalanobis distance
    K: np.ndarray       # (..., 2, 2) Kalman gain
    z_exp: np.ndarray   # (..., 2)    expected measurement
    innov: np.ndarray   # (..., 2)    wrapped innovation


def ekf_correct(pose, lm_mean, lm_cov, z, R) -> EKFRef:
    """Range-bearing EKF correction (KalmanFilter.hpp:240-245), broadcast
    over leading axes: ``pose (..., 3)``, ``lm_mean (..., 2)``,
    ``lm_cov (..., 2, 2)``, ``z (..., 2)``."""
    pose, lm_mean, lm_cov, z, R = (np.asarray(a, np.float64) for a in
                                   (pose, lm_mean, lm_cov, z, R))
    dx = lm_mean[..., 0] - pose[..., 0]
    dy = lm_mean[..., 1] - pose[..., 1]
    r2 = dx * dx + dy * dy
    r = np.sqrt(r2)
    z_exp = np.stack([r, wrap(np.arctan2(dy, dx) - pose[..., 2])], axis=-1)
    H = np.stack([np.stack([dx / r, dy / r], -1),
                  np.stack([-dy / r2, dx / r2], -1)], -2)
    Ht = np.swapaxes(H, -1, -2)
    S = H @ lm_cov @ Ht + R
    Sinv = np.linalg.inv(S)
    K = lm_cov @ Ht @ Sinv
    P = (np.eye(2) - K @ H) @ lm_cov
    P = 0.5 * (P + np.swapaxes(P, -1, -2))
    innov = z - z_exp
    innov[..., 1] = wrap(innov[..., 1])
    m = lm_mean + (K @ innov[..., None])[..., 0]
    md2 = np.einsum("...i,...ij,...j->...", innov, Sinv, innov)
    lik = np.exp(-0.5 * md2) / np.sqrt((2 * np.pi) ** 2 * np.linalg.det(S))
    return EKFRef(m, P, lik, md2, K, z_exp, innov)


# ------------------------------------------------------ RFS likelihood
def rfs_log_likelihood(L, pd, clutter, log_clutter_integral):
    """Log of the sum over all partial matchings of an ``[E, Z]`` table
    (RBPHDFilter.hpp:961-988's enumeration), including the reference's
    zero-partition quirk: rows with no gated measurement multiply by Pd,
    not 1 - Pd (RBPHDFilter.hpp:905-917).  Matchings only use cells with
    ``L > 0`` (a zero cell zeroes its term)."""
    L = np.asarray(L, np.float64)
    pd = np.asarray(pd, np.float64)
    clutter = np.asarray(clutter, np.float64)
    E = L.shape[0]
    miss = np.where(L.max(axis=1) > 0, 1.0 - pd, pd)
    cols = [np.nonzero(L[r] > 0)[0] for r in range(E)]

    # a matched column trades its clutter factor for L[r, c]
    def rec(r, used):
        if r == E:
            return 1.0
        total = miss[r] * rec(r + 1, used)
        for c in cols[r]:
            if c not in used:
                total += L[r, c] / clutter[c] * rec(r + 1, used | {int(c)})
        return total

    return float(np.log(np.prod(clutter) * rec(0, frozenset()))
                 - log_clutter_integral)


# ----------------------------------------------------------- assignment
def murty_scores(cost, k):
    """The ``k`` best max-sum assignment scores of a square ``cost`` matrix
    by Murty's partitioning, each subproblem solved by SciPy's
    ``linear_sum_assignment`` (MurtyAlgorithm.cpp:141-338)."""
    from scipy.optimize import linear_sum_assignment

    cost = np.asarray(cost, np.float64)
    n = cost.shape[0]
    big = 1e6 * (1.0 + np.abs(cost).max())

    def solve(forced, banned):
        c = cost.copy()
        for r, col in banned:
            c[r, col] = -big
        for r, col in forced:
            keep = c[r, col]
            c[r, :] = -big
            c[:, col] = -big
            c[r, col] = keep
        rows, sol = linear_sum_assignment(c, maximize=True)
        if c[rows, sol].min() <= -big / 2:
            return None
        return sol, float(cost[rows, sol].sum())

    first = solve((), ())
    heap = [(-first[1], 0, first[0], (), ())]
    tie = 1
    out = []
    while heap and len(out) < k:
        neg, _, sol, forced, banned = heapq.heappop(heap)
        out.append(-neg)
        if len(out) == k:
            break
        fixed = {r for r, _ in forced}
        free = [r for r in range(n) if r not in fixed]
        for j, r in enumerate(free):
            child_forced = forced + tuple((q, int(sol[q])) for q in free[:j])
            child = solve(child_forced, banned + ((r, int(sol[r])),))
            if child is not None:
                heapq.heappush(heap, (-child[1], tie, child[0], child_forced,
                                      banned + ((r, int(sol[r])),)))
                tie += 1
    return np.asarray(out)


# ------------------------------------------------------- map maintenance
def _compact_order(w, alive):
    """Slot order of ``gm.compact``: alive by descending weight, then dead,
    ties by index."""
    score = np.where(alive, w, -np.inf)
    return np.argsort(-score, axis=-1, kind="stable")


def merge(mean, cov, w, w_prev, alive, threshold, f_inflation,
          max_passes=8):
    """GM merge (GaussianMixture.hpp:394-475) as ``gm.merge`` defines it:
    slots sorted by descending weight, then parallel passes of disjoint
    pairwise merges until no pair merges (at most ``max_passes`` passes).

    In a pass, i < j merge when either mean lies within ``threshold`` in
    the other's Mahalanobis metric; only a component with no smaller gated
    partner may absorb (the safe-absorber rule, which conserves mass in
    broken chains); each such i absorbs its lowest claimed j, and each j
    goes to its lowest absorber.

    Dense float64 arrays: ``mean [P, M, D]``, ``cov [P, M, D, D]``,
    ``w``, ``w_prev``, ``alive`` ``[P, M]``.  Returns the same tuple.
    """
    mean, cov, w, w_prev = (np.array(a, np.float64) for a in
                            (mean, cov, w, w_prev))
    alive = np.array(alive, bool)
    P, M, D = mean.shape
    order = _compact_order(w, alive)
    take = lambda a: np.take_along_axis(
        a, order.reshape(order.shape + (1,) * (a.ndim - 2)), axis=1)
    mean, cov, w, w_prev, alive = map(take, (mean, cov, w, w_prev, alive))
    t2 = threshold * threshold
    for _ in range(max_passes):
        n_merged = 0
        for p in range(P):
            inv = np.linalg.inv(cov[p])
            diff = mean[p][None, :, :] - mean[p][:, None, :]    # [i, j, D]
            d2_ij = np.einsum("ijd,ide,ije->ij", diff, inv, diff)
            gate = (alive[p][:, None] & alive[p][None, :]
                    & np.triu(np.ones((M, M), bool), 1)
                    & ((d2_ij <= t2) | (d2_ij.T <= t2)))
            can_absorb = ~gate.any(axis=0)
            safe = gate & can_absorb[:, None]
            absorber = {}
            for j in range(M):
                ii = np.nonzero(safe[:, j])[0]
                if len(ii):
                    absorber.setdefault(int(ii[0]), []).append(j)
            for i, js in absorber.items():
                j = js[0]
                wm = w[p, i] + w[p, j]
                if wm == 0:
                    continue
                w1, w2 = w[p, i] / wm, w[p, j] / wm
                xm = w1 * mean[p, i] + w2 * mean[p, j]
                d1, d2 = xm - mean[p, i], xm - mean[p, j]
                cov[p, i] = (w1 * (cov[p, i] + f_inflation * np.outer(d1, d1))
                             + w2 * (cov[p, j]
                                     + f_inflation * np.outer(d2, d2)))
                mean[p, i] = xm
                w[p, i] = wm
                w_prev[p, i] = 0.0
                alive[p, j] = False
                n_merged += 1
        if n_merged == 0:
            break
    return mean, cov, w, w_prev, alive


def replace_weakest(mean, cov, w, w_prev, alive, new_mean, new_cov, new_w,
                    new_alive):
    """``gm.replace_weakest`` by plain indexing: sort the new entries by
    descending weight and the old slots by ascending weight (dead first,
    ties by index); the i-th new entry replaces the i-th weakest old slot
    iff it is strictly heavier.  Planes as the op takes them: ``mean``
    ``[D, P, M]``, ``cov`` ``[T, P, M]``, the rest ``[P, M]`` and the new
    arrays with K in place of M.  Returns ``(mean, cov, w, w_prev, alive)``.
    """
    mean, cov, w, w_prev = (np.array(a) for a in (mean, cov, w, w_prev))
    alive = np.array(alive, bool)
    P, M = w.shape
    K = min(new_w.shape[1], M)
    score_new = np.where(new_alive, new_w, -np.inf)
    score_old = np.where(alive, w, -np.inf)
    for p in range(P):
        src = np.argsort(-score_new[p], kind="stable")[:K]
        dst = np.argsort(score_old[p], kind="stable")[:K]
        for s, d in zip(src, dst):
            if not score_new[p, s] > score_old[p, d]:
                break
            mean[:, p, d] = new_mean[:, p, s]
            cov[:, p, d] = new_cov[:, p, s]
            w[p, d] = new_w[p, s]
            w_prev[p, d] = 0.0
            alive[p, d] = new_alive[p, s]
    return mean, cov, w, w_prev, alive


def rbphd_map_update(pose, mean, cov, w, w_prev, alive, z, z_mask, R,
                     pd_const, clutter, r_max, r_min, r_buf, range_t,
                     bearing_t, md_threshold, birth_weight, new_per_z,
                     new_capacity):
    """The RB-PHD map update (RBPHDFilter.hpp:543-725) as
    ``RBPHDFilter._map_update`` defines it for the 2-D range-bearing model:
    Pd with the buffer-zone rule, the EKF for every (particle, measurement,
    landmark), the column-normalized weight table, missed-detection weights,
    unused measurements, and the new Gaussians — per measurement the
    ``new_per_z`` heaviest cells, then the ``new_capacity`` heaviest overall
    — inserted by :func:`replace_weakest`.

    Planes as the filter stores them (``mean [2, P, M]``, packed ``cov
    [3, P, M]``); returns a dict of float64 arrays: ``mean, cov, w, w_prev,
    alive`` (the updated map), ``unused [P, Zc]``, ``n_in_fov [P]`` and
    ``col_sum [P, Zc]``.
    """
    f64 = lambda a: np.asarray(a, np.float64)
    pose, mean, cov, w, w_prev, z = map(f64, (pose, mean, cov, w, w_prev, z))
    alive = np.asarray(alive, bool)
    z_mask = np.asarray(z_mask, bool)
    P, M = w.shape
    lm = np.moveaxis(mean, 0, -1)                                 # [P, M, 2]
    C = np.stack([np.stack([cov[0], cov[1]], -1),
                  np.stack([cov[1], cov[2]], -1)], -2)            # [P,M,2,2]

    r = np.hypot(lm[..., 0] - pose[:, None, 0], lm[..., 1] - pose[:, None, 1])
    inside = (r <= r_max) & (r >= r_min)
    close = ((inside & ((r >= r_max - r_buf) | (r <= r_min + r_buf)))
             | (~inside & (r <= r_max + r_buf) & (r >= r_min - r_buf)))
    close &= alive
    pd = np.where(close, 1.0, np.where(alive & inside, pd_const, 0.0))
    n_in_fov = np.sum((pd != 0.0) & alive, axis=1)

    ekf = ekf_correct(pose[:, None, None, :], lm[:, None], C[:, None],
                      z[None, :, None, :], R)                   # [P, Zc, M]
    in_range = inside[:, None, :]
    gated = ((np.abs(ekf.innov[..., 0]) <= range_t)
             & (np.abs(ekf.innov[..., 1]) <= bearing_t) & in_range)
    lik = np.where(gated, ekf.lik, 0.0)
    cell = (alive[:, None, :] & (pd[:, None, :] > 0) & z_mask[None, :, None]
            & (ekf.md2 <= md_threshold ** 2) & (lik > 0))
    w_tab = np.where(cell, pd[:, None, :] * w[:, None, :] * lik, 0.0)
    col_sum = clutter + w_tab.sum(axis=2)
    w_tab = np.where(z_mask[None, :, None], w_tab / col_sum[:, :, None], 0.0)

    w_miss = (1.0 - pd) * w
    delta = pd * w - w_tab.sum(axis=1)
    comp = close & (w > birth_weight) & (delta > 0)
    w_miss = np.where(comp, np.minimum(w_miss + delta, 1.0), w_miss)
    unused = z_mask[None, :] & ~np.any(w_tab > 0, axis=2)

    Zc = z.shape[0]
    K = min(new_capacity, Zc * min(new_per_z, M))
    new_mean = np.zeros((2, P, K))
    new_cov = np.zeros((3, P, K))
    new_w = np.zeros((P, K))
    T = min(new_per_z, M)
    for p in range(P):
        # candidate i * Zc + k is measurement k's i-th heaviest cell; equal
        # weights keep that order (lowest index first, like top_k)
        ranked = np.argsort(-w_tab[p], axis=1, kind="stable")[:, :T]
        cands = [(w_tab[p, k, ranked[k, i]], k, ranked[k, i])
                 for i in range(T) for k in range(Zc)
                 if w_tab[p, k, ranked[k, i]] > 0]
        cands.sort(key=lambda c: -c[0])
        for i, (wt, k, m) in enumerate(cands[:K]):
            new_mean[:, p, i] = ekf.mean[p, k, m]
            P_ = ekf.cov[p, 0, m]
            new_cov[:, p, i] = (P_[0, 0], P_[0, 1], P_[1, 1])
            new_w[p, i] = wt
    out = replace_weakest(
        mean, cov, np.where(alive, w_miss, w), np.where(alive, w, w_prev),
        alive, new_mean, new_cov, new_w, new_w > 0)
    return dict(zip(("mean", "cov", "w", "w_prev", "alive"), out),
                unused=unused, n_in_fov=n_in_fov, col_sum=col_sum)
