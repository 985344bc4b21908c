"""Gaussian-mixture map maintenance as fixed-shape masked ops.

Replaces ``GaussianMixture<Landmark>``'s dynamic vector operations
(reference: GaussianMixture.hpp:51-534) with capacity-padded batched
equivalents over the plane-major SoA map (:mod:`rfs_slam_tpu.core.state`):

* ``prune``    — weight-threshold pruning (GaussianMixture.hpp:477-521 keeps
                 Gaussians with w >= t);
* ``compact``  — sort-by-weight + truncate-to-capacity, the fixed-shape
                 analog of ``sortByWeight`` + vector resize;
* ``merge``    — pairwise moment-matched merging with the Mahalanobis gate and
                 covariance inflation of GaussianMixture.hpp:394-475.  The
                 reference's greedy in-order scan is inherently sequential;
                 here each pass merges a maximal set of disjoint (lowest-index
                 first) pairs and passes repeat until no pair merges, which
                 reproduces the reference's fixed point up to ordering
                 (parity is statistical, as for all order-dependent heuristics
                 — see SURVEY.md section 7);
* ``append``   — masked append of new Gaussians followed by ``compact``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from rfs_slam_tpu.core import planar
from rfs_slam_tpu.core.state import GMState

_BIG = jnp.inf
# one-hot products must reproduce their operand exactly: float32 at full
# precision (a default-precision f32 dot may run in TF32 on the GPU)
_EXACT = jax.lax.Precision.HIGHEST


def prune(gm: GMState, threshold) -> GMState:
    """Drop Gaussians with weight < threshold (GaussianMixture.hpp:477-521)."""
    return gm.replace(alive=gm.alive & (gm.w >= threshold))


def take_slots(gm: GMState, idx: jax.Array) -> GMState:
    """Per-particle slot gather: ``idx[P, K]`` -> GMState with capacity K.

    Uses the one-hot multiply-reduce of :func:`planar.take_lane`.
    """
    oh = planar.onehot(idx, gm.capacity, gm.w.dtype)        # [P, K, M]
    take_pm = lambda a: planar.take_lane(a, oh)
    take_pl = lambda a: planar.take_lane(a, oh[None])
    return GMState(
        mean=take_pl(gm.mean),
        cov=take_pl(gm.cov),
        w=take_pm(gm.w),
        w_prev=take_pm(gm.w_prev),
        alive=take_pm(gm.alive.astype(gm.w.dtype)) > 0.5,
    )


def compact(gm: GMState, capacity: int) -> GMState:
    """Keep the top-``capacity`` Gaussians per particle by weight.

    Dead slots sort last.  This is the fixed-shape replacement for
    ``sortByWeight`` (GaussianMixture.hpp:523-529); overflow beyond capacity
    drops the lowest-weight Gaussians (the reference grows storage instead —
    capacity should be sized so this only triggers as a safety valve).
    """
    score = jnp.where(gm.alive, gm.w, -_BIG)
    _, idx = jax.lax.top_k(score, capacity)  # [P, capacity]
    return take_slots(gm, idx)


def append(gm: GMState, mean, cov, w, alive, capacity: int | None = None) -> GMState:
    """Append new Gaussians (w_prev = 0, GaussianMixture.hpp:267-308) and
    re-compact to capacity.  ``mean``: [D, P, K], ``cov``: [T, P, K] planes."""
    capacity = capacity or gm.capacity
    out = GMState(
        mean=jnp.concatenate([gm.mean, mean], axis=2),
        cov=jnp.concatenate([gm.cov, cov], axis=2),
        w=jnp.concatenate([gm.w, w], axis=1),
        w_prev=jnp.concatenate([gm.w_prev, jnp.zeros_like(w)], axis=1),
        alive=jnp.concatenate([gm.alive, alive], axis=1),
    )
    return compact(out, capacity)


def replace_weakest(gm: GMState, mean, cov, w, alive,
                    sorted_desc: bool = False) -> GMState:
    """Insert K new Gaussians by replacing the K weakest slots — the exact
    fixed-shape equivalent of ``append`` + ``compact`` (top-capacity of the
    union) without the capacity+K concat and the (capacity+K)-wide sort.

    Two-pointer exchange: with the K weakest old slots in ascending order
    v_1 <= ... <= v_K and the new weights in descending order
    n_1 >= ... >= n_K, the kept set ``old \\ {v_i : n_i > v_i} + {n_i :
    n_i > v_i}`` is the top-capacity of the union (the predicate
    ``n_i > v_i`` is monotone over i, so exactly the j largest new entries
    displace the j smallest old ones).  Ties keep the old slot (same weight
    multiset either way).

    ``mean``: [D, P, K], ``cov``: [T, P, K] planes; ``w``/``alive``: [P, K].
    ``sorted_desc``: set when (w, alive) columns are already sorted by
    descending score (e.g. straight out of ``top_k``) to skip the K-sort.
    """
    P, K = w.shape
    score_new = jnp.where(alive, w, -_BIG)
    if not sorted_desc:
        score_new, order = jax.lax.top_k(score_new, K)
        oh = planar.onehot(order, K, gm.w.dtype)        # [P, K, K]
        mean = planar.take_lane(mean, oh[None])
        cov = planar.take_lane(cov, oh[None])
        w = planar.take_lane(w, oh)
        alive = planar.take_lane(alive.astype(gm.w.dtype), oh) > 0.5

    if K > gm.capacity:
        # only the strongest `capacity` new entries can possibly enter
        # (columns are sorted descending at this point)
        K = gm.capacity
        mean, cov = mean[:, :, :K], cov[:, :, :K]
        w, alive, score_new = w[:, :K], alive[:, :K], score_new[:, :K]
    score_old = jnp.where(gm.alive, gm.w, -_BIG)
    neg_v, victim = jax.lax.top_k(-score_old, K)        # weakest K, ascending
    repl = score_new > -neg_v                           # [P, K] prefix-true
    oh_v = planar.onehot(victim, gm.capacity, gm.w.dtype) * repl[..., None]
    keep = jnp.sum(oh_v, axis=1) < 0.5                  # [P, M] untouched

    def insert_pm(old, new):
        return (jnp.where(keep, old, 0.0)
                + jnp.einsum("pkm,pk->pm", oh_v, new, precision=_EXACT))

    def insert_pl(old, new):
        return (jnp.where(keep[None], old, 0.0)
                + jnp.einsum("pkm,xpk->xpm", oh_v, new, precision=_EXACT))

    alive_f = alive.astype(gm.w.dtype)
    return GMState(
        mean=insert_pl(gm.mean, mean),
        cov=insert_pl(gm.cov, cov),
        w=insert_pm(gm.w, w),
        w_prev=insert_pm(gm.w_prev, jnp.zeros_like(w)),
        alive=(insert_pm(gm.alive.astype(gm.w.dtype), alive_f) > 0.5),
    )


def _merge_pass(gm: GMState, t2, f_inflation):
    """One parallel pass of disjoint pairwise merges.

    Gate (GaussianMixture.hpp:430-441): merge j into i (i < j) when the
    Mahalanobis distance of one mean under the other's covariance is within
    t^2 (the reference checks i->j then j->i; OR).
    """
    D = gm.dim
    P, M = gm.w.shape
    idx = jnp.arange(M)
    cov_inv = planar.inv_sym(gm.cov, D)                      # [T,P,M]
    # diff[d][p,i,j] = mean[d][p,j] - mean[d][p,i]
    diff = [gm.mean[d][:, None, :] - gm.mean[d][:, :, None] for d in range(D)]
    d2_ij = planar.quad_sym(cov_inv[:, :, :, None], diff, D)  # [P,i,j]
    d2_ji = jnp.swapaxes(d2_ij, 1, 2)
    both_alive = gm.alive[:, :, None] & gm.alive[:, None, :]
    upper = idx[None, :, None] < idx[None, None, :]
    gate = both_alive & upper & ((d2_ij <= t2) | (d2_ji <= t2))

    # lowest-index i claims each j; each i merges with its lowest claimed j.
    # NOTE: pair choice depends on slot order — callers sort slots by
    # descending weight first (gm_ops.merge does) so heavier Gaussians
    # absorb lighter ones, matching the reference's mostly-weight-sorted
    # vector order (prune re-sorts it every update, GaussianMixture.hpp:477).
    #
    # SAFE-ABSORBER rule: only a component with NO smaller gated partner may
    # absorb this pass.  Without it a broken chain (k-x gated, x-j gated,
    # k-j not) lets x absorb j in the same pass in which k absorbs x's
    # PRE-merge weight — j's mass is silently lost (found round 4; pinned
    # by test_merge_conserves_mass_in_broken_chain).  A deferred x simply
    # absorbs on a later pass; the fixpoint is unchanged and mass conserves.
    i_ids = jnp.broadcast_to(idx[None, :, None], gate.shape)
    first_any = jnp.min(jnp.where(gate, i_ids, M), axis=1)     # [P, j]
    can_absorb = first_any == M                                # [P, i]
    safe_gate = gate & can_absorb[:, :, None]
    first_i = jnp.min(jnp.where(safe_gate, i_ids, M), axis=1)  # [P, j]
    claimed = safe_gate & (i_ids == first_i[:, None, :])
    j_ids = jnp.broadcast_to(idx[None, None, :], gate.shape)
    j_star = jnp.min(jnp.where(claimed, j_ids, M), axis=2)     # [P, i]
    has_pair = j_star < M
    j_safe = jnp.where(has_pair, j_star, 0)

    take_pm = lambda a: jnp.take_along_axis(a, j_safe, axis=1)
    take_pl = lambda a: jnp.take_along_axis(a, j_safe[None], axis=2)
    w1, w2 = gm.w, take_pm(gm.w)
    wm = w1 + w2
    ok = has_pair & (wm != 0)
    x2 = take_pl(gm.mean)                                      # [D,P,M]
    S2 = take_pl(gm.cov)                                       # [T,P,M]
    w1n = w1[None] / wm[None]
    w2n = w2[None] / wm[None]
    xm = gm.mean * w1n + x2 * w2n                              # [D,P,M]
    d1 = [xm[d] - gm.mean[d] for d in range(D)]
    d2v = [xm[d] - x2[d] for d in range(D)]
    # Sm = (w1 (S1 + f d1 d1^T) + w2 (S2 + f d2 d2^T)) / wm
    sm = []
    for i in range(D):
        for j in range(i, D):
            k = planar.tri_index(i, j, D)
            sm.append(
                w1n[0] * (gm.cov[k] + f_inflation * d1[i] * d1[j])
                + w2n[0] * (S2[k] + f_inflation * d2v[i] * d2v[j])
            )
    Sm = jnp.stack(sm, axis=0)

    okD = ok[None]
    new_mean = jnp.where(okD, xm, gm.mean)
    new_cov = jnp.where(okD, Sm, gm.cov)
    new_w = jnp.where(ok, wm, gm.w)
    new_w_prev = jnp.where(ok, 0.0, gm.w_prev)
    # kill merged-away j slots (one-hot reduce)
    merged_j = jnp.any(
        (j_safe[:, :, None] == idx[None, None, :]) & ok[:, :, None], axis=1
    )
    new_alive = gm.alive & ~merged_j
    n_merged = jnp.sum(ok)
    return (
        GMState(new_mean, new_cov, new_w, new_w_prev, new_alive),
        n_merged,
    )


def merge(gm: GMState, threshold, f_inflation, max_passes: int = 8) -> GMState:
    """Merge until fixed point (bounded passes).

    Reference: GaussianMixture.hpp:394-416 (O(M^2) greedy in-order scan —
    the vector is weight-sorted from the previous update's prune, so heavier
    Gaussians absorb lighter ones).  Slots are sorted by descending weight at
    entry to reproduce that: the pass's lowest-index-first pair claiming is
    slot-order dependent, and unsorted entry measurably degrades the filter
    (bench median pose error 0.03 -> 0.17 m).
    """
    gm = compact(gm, gm.capacity)
    t2 = threshold * threshold

    def cond(carry):
        _, n, it = carry
        return (n > 0) & (it < max_passes)

    def body(carry):
        gg, _, it = carry
        gg, n = _merge_pass(gg, t2, f_inflation)
        return gg, n, it + 1

    g1, n1 = _merge_pass(gm, t2, f_inflation)
    out, _, _ = jax.lax.while_loop(cond, body, (g1, n1, jnp.int32(1)))
    return out
