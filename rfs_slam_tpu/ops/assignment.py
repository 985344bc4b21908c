"""Linear-assignment solvers as batched fixed-shape JAX programs.

Covers the reference's L4 combinatorics inventory (SURVEY.md section 2.5):

* :func:`hungarian`   — O(n^3) Jonker-Volgenant-style shortest-augmenting-path
  algorithm with potentials (replaces HungarianMethod.hpp:56-594); exact, no
  epsilon approximation, vmappable over a batch of cost matrices;
* :func:`murty`       — k-best assignments by Murty partitioning over a fixed
  subproblem pool (replaces MurtyAlgorithm.cpp:141-338);
* :func:`brute_force_assignments` — NumPy enumeration oracle
  (BruteForceAssignment.hpp:45-88), test-only;
* :func:`matrix_permanent` — Ryser-formula permanent
  (MatrixPermanent.hpp:39-68);
* lexicographic enumeration equivalents live in the RFS likelihood DP
  (ops/rfs_likelihood.py), which sums ALL assignments exactly.

Conventions: square cost matrix, MAXIMIZATION of the sum (the reference's DA
uses log-likelihood max; for min problems negate).  Invalid/disallowed
entries should be a large negative number (not -inf: keep arithmetic finite).
"""

from __future__ import annotations

import itertools

import jax
import jax.numpy as jnp
import numpy as np

NEG = -1e9  # "disallowed" sentinel, finite to keep potentials well-defined


def hungarian(cost: jax.Array):
    """Exact max-sum perfect assignment on an [n, n] cost matrix.

    Returns ``(row_to_col [n] int32, total float)``.  Batched via vmap.
    Shortest-augmenting-path formulation with dual potentials; all loops are
    fixed-bound ``fori``/``while_loop`` so the program is one compiled kernel.
    """
    row_to_col, total, _, _ = _hungarian_uv(cost)
    return row_to_col, total


def _hungarian_uv(cost: jax.Array):
    """:func:`hungarian` + the optimal dual potentials ``(u, v)`` [n+1]
    (1-indexed rows/cols; slot 0 is the virtual column).  For the MINIMIZED
    matrix ``a = -cost`` the duals satisfy ``u[i+1] + v[j+1] <= a[i, j]``
    with equality on assigned pairs — the certificate Murty's dual child
    bound is built from (see :func:`murty`)."""
    n = cost.shape[-1]
    a = -cost  # minimize
    INF = jnp.asarray(jnp.finfo(a.dtype).max / 8, a.dtype)

    # 1-indexed columns with virtual column 0
    u = jnp.zeros((n + 1,), a.dtype)
    v = jnp.zeros((n + 1,), a.dtype)
    p = jnp.zeros((n + 1,), jnp.int32)        # p[j] = row assigned to col j

    def assign_row(i, carry):
        u, v, p = carry
        minv = jnp.full((n + 1,), INF, a.dtype)
        used = jnp.zeros((n + 1,), bool)
        way = jnp.zeros((n + 1,), jnp.int32)

        def cond(st):
            _, _, _, _, j0, _, _ = st
            return p[j0] != 0

        def cond2(st):
            minv, used, way, u_v, j0, p_, it = st
            return (p_[j0] != 0) & (it <= n + 1)

        rows_n1 = jnp.arange(n + 1)

        def body(st):
            minv, used, way, (u, v), j0, p_, it = st
            # all updates keyed by the per-instance scalar j0 are written as
            # elementwise one-hot selects, so the vmapped loop body stays a
            # fused elementwise program (no batched scatter)
            used = used | (rows_n1 == j0)
            i0 = p_[j0]
            cols = jnp.arange(n + 1)
            cur = a[i0 - 1, :] - u[i0] - v[1:]       # [n] for cols 1..n
            cur = jnp.concatenate([jnp.full((1,), INF, a.dtype), cur])
            better = (~used) & (cur < minv)
            minv = jnp.where(better, cur, minv)
            way = jnp.where(better, j0, way)
            delta_candidates = jnp.where(used, INF, minv)
            j1 = jnp.argmin(delta_candidates).astype(jnp.int32)
            delta = delta_candidates[j1]
            # u[p_[j]] += delta for used j, as a one-hot multiply-reduce
            # (no batched scatter-add under vmap)
            hits = jnp.sum(
                (p_[None, :] == rows_n1[:, None]) & used[None, :], axis=1
            ).astype(u.dtype)                        # [n+1] rows
            u = u + delta * hits
            v = jnp.where(used, v - delta, v)
            minv = jnp.where(used, minv, minv - delta)
            return minv, used, way, (u, v), j1, p_, it + 1

        p = p.at[0].set(jnp.int32(i + 1))
        st = (minv, used, way, (u, v), jnp.int32(0), p, jnp.int32(0))
        minv, used, way, (u, v), j0, p, _ = jax.lax.while_loop(cond2, body, st)

        # augment along parent links.  BOUND the walk: if the search loop
        # above exited via its iteration cap (f32 potential drift can trip
        # it where fusion order rounds differently), `way` may hold a broken
        # or cyclic chain, and an unbounded walk would never end.  A capped
        # walk degrades
        # that pathological row to a possibly suboptimal assignment instead
        # of crashing; exactness on sane inputs is unchanged (the chain
        # length is at most n+1).
        def aug_cond(st):
            j0, _, it = st
            return (j0 != 0) & (it <= n + 1)

        def aug_body(st):
            j0, p_, it = st
            j1 = way[j0]
            p_ = jnp.where(rows_n1 == j0, p_[j1], p_)
            return j1, p_, it + 1

        _, p, _ = jax.lax.while_loop(aug_cond, aug_body,
                                     (j0, p, jnp.int32(0)))
        p = p.at[0].set(0)
        return u, v, p

    u, v, p = jax.lax.fori_loop(0, n, assign_row, (u, v, p))
    # p[j] = row for col j (1-indexed); invert via one-hot reduce (a scatter
    # here would serialize under vmap, see body())
    cols_n = jnp.arange(n, dtype=jnp.int32)
    # max (not sum) reduce: if the capped augment walk above left a broken
    # chain, p can contain duplicate rows; summing their column indices could
    # produce an out-of-range column for the degraded row, while max keeps it
    # in [0, n-1] (merely suboptimal, as intended).
    row_to_col = jnp.max(
        jnp.where((p[1:] - 1)[None, :] == cols_n[:, None], cols_n[None, :], 0),
        axis=1,
    )
    total = jnp.sum(cost[jnp.arange(n), row_to_col])
    return row_to_col, total, u, v


hungarian_batched = jax.vmap(hungarian)


def murty(cost: jax.Array, k: int,
          real_rows: int | None = None, real_cols: int | None = None,
          child_cap: int | None = None,
          prune_window: float | None = None,
          return_nvalid: bool = False):
    """k-best max-sum assignments by Murty partitioning.

    Returns ``(assignments [k, n] int32, scores [k], valid [k] bool)`` in
    descending score order.  Reference: MurtyAlgorithm.cpp:141-338 (priority
    queue of subproblems, each solved by Hungarian).  Pool is fixed at
    ``k * partition_max + 1`` subproblems; assignments forced below ``NEG/2``
    total are marked invalid (the reference stops at rank -1).

    ``real_rows``/``real_cols`` (static ints) restrict partitioning to the
    real assignment block of a missdetection/clutter-augmented matrix
    (``Murty::setRealAssignmentBlock``, MurtyAlgorithm.cpp:126-135, applied
    at :181-186 and :255-262):

    * children are spawned only for rows ``< real_rows`` — hypotheses differ
      in REAL measurement-to-landmark pairings, never in how augmented
      (missdetection/clutter) rows are arranged;
    * banning an assignment of a row to an augmented column bans that row
      from ALL augmented columns — augmented columns are interchangeable, so
      forbidding only one would re-enumerate the same real association with a
      different padding column.

    Together these make the k returned hypotheses distinct in their real
    blocks (the property MH-FastSLAM's hypothesis budget relies on,
    FastSLAM.hpp:504-543).  Both may be static Python ints or traced int
    scalars (per-particle in-range landmark counts are data-dependent).

    ``child_cap`` (static int) bounds the number of Murty children SOLVED
    per expansion wave: with traced ``real_rows`` the uncapped wave width is
    ``n - 1`` even though only ~``real_rows`` children are ever valid, and
    the vmapped Hungarian's cost scales with wave width (every lane waits
    for the slowest), so a small static bound cuts the MH-FastSLAM murty
    call by about the ratio of the widths.  When the cap binds, children are
    kept in DESCENDING DUAL-BOUND order: for the child that bans parent
    assignment (r, c), the parent's optimal duals certify
    ``child_best <= parent_best - min_{j != c} slack[r, j]`` (slack of the
    minimized effective matrix; the classic Murty speedup —
    MurtyAlgorithm.cpp's queue discipline achieves the same pruning
    sequentially), so the dropped children are those provably weakest, not
    those of the weakest-ranked table rows.  EXACT whenever the number of
    valid children at every expansion stays <= child_cap; beyond that the
    truncation error is bounded by the discarded bounds.

    ``prune_window`` (static float): also mark a child INVALID when its dual
    upper bound falls more than ``prune_window`` below the best (first)
    assignment's score.  Its whole subtree is then provably outside the
    window too, so the k-best WITHIN the window are returned exactly — this
    matches MH-FastSLAM's ``maxDataAssocLogLikelihoodDiff`` discard
    (FastSLAM.hpp:513-523), which drops such hypotheses anyway.  With
    ``prune_window`` set, fewer than ``k`` valid rows may return even when
    k distinct assignments exist.

    ``return_nvalid``: additionally return ``n_valid [k-1] int32`` — the
    number of bound-surviving children at each expansion wave BEFORE the
    cap, so callers can count how often ``child_cap`` truncates
    (``sum(max(0, n_valid - child_cap))``).
    """
    n = cost.shape[-1]
    nR = n if real_rows is None else real_rows
    nC = n if real_cols is None else real_cols
    static_dims = isinstance(nR, int) and isinstance(nC, int)
    if static_dims:
        nR, nC = min(nR, n), min(nC, n)
        partition_bound = n - 1 if nR >= n else nR  # loop/pool sizing
    else:
        partition_bound = n - 1 if n > 1 else 1
    all_cols_real = static_dims and nC >= n  # skip aug-col widening entirely
    partition_max = jnp.where(jnp.asarray(nR) >= n, n - 1, nR)
    nC = jnp.asarray(nC)
    pb_full = max(partition_bound, 1)        # candidate child rows per wave
    pb = pb_full if child_cap is None else max(1, min(child_cap, pb_full))
    pool = (k - 1) * pb + 1                  # only k-1 waves expand children

    # subproblem representation: forced[r] = col forced for row r (-1 free);
    # bans as a COMPACT list of at most k entries (ban_r, ban_c, ban_aug) —
    # a Murty child adds exactly one ban to its parent and tree depth is
    # bounded by k, so a dense [pool, n, n] ban cube (83 MB at FastSLAM
    # bench shapes) is never needed.  ban_aug marks the reference's
    # augmented-column widening (MurtyAlgorithm.cpp:255-262): ban the row
    # from EVERY column >= nC.
    forced0 = jnp.full((pool, n), -1, jnp.int32)
    ban_r0 = jnp.full((pool, k), -1, jnp.int32)
    ban_c0 = jnp.zeros((pool, k), jnp.int32)
    ban_aug0 = jnp.zeros((pool, k), bool)
    sol0 = jnp.zeros((pool, n), jnp.int32)
    score0 = jnp.full((pool,), -jnp.inf, cost.dtype)
    active0 = jnp.zeros((pool,), bool)
    # dual potentials of each solved subproblem (for the child bound)
    us0 = jnp.zeros((pool, n + 1), cost.dtype)
    vs0 = jnp.zeros((pool, n + 1), cost.dtype)

    cols = jnp.arange(n)

    def build_eff(forced, ban_r, ban_c, ban_aug):
        """Effective cost matrix of a subproblem (bans + forcing applied)."""
        c = cost
        for b in range(k):
            row_hit = cols == ban_r[b]                      # [n]
            col_hit = (cols == ban_c[b]) | (ban_aug[b] & (cols >= nC))
            c = jnp.where((ban_r[b] >= 0)
                          & row_hit[:, None] & col_hit[None, :], NEG, c)
        is_forced = forced >= 0
        forced_mask = (cols[None, :] == forced[:, None]) & is_forced[:, None]
        return jnp.where(is_forced[:, None] & ~forced_mask, NEG, c)

    def solve(forced, ban_r, ban_c, ban_aug):
        sol, total, u, v = _hungarian_uv(
            build_eff(forced, ban_r, ban_c, ban_aug))
        return sol, total, u, v

    sol, total, u_r, v_r = solve(forced0[0], ban_r0[0], ban_c0[0], ban_aug0[0])
    sol0 = sol0.at[0].set(sol)
    score0 = score0.at[0].set(total)
    active0 = active0.at[0].set(True)
    us0 = us0.at[0].set(u_r)
    vs0 = vs0.at[0].set(v_r)
    root_score = total

    out_sols = jnp.zeros((k, n), jnp.int32)
    out_scores = jnp.full((k,), -jnp.inf, cost.dtype)
    out_valid = jnp.zeros((k,), bool)
    nvalid0 = jnp.zeros((max(k - 1, 1),), jnp.int32)

    cand_rows = jnp.arange(pb_full)

    def iteration(t, carry):
        (forced, ban_r, ban_c, ban_aug, sols, scores, active, us, vs,
         out_sols, out_scores, out_valid, n_valid_log) = carry
        best = jnp.argmax(jnp.where(active, scores, -jnp.inf)).astype(jnp.int32)
        best_score = scores[best]
        best_sol = sols[best]
        ok = active[best] & (best_score > NEG / 2)
        if prune_window is not None:
            # the dual bound prunes subtrees conservatively (ub >= true
            # score); filter the remainder exactly at extraction
            ok &= best_score >= root_score - prune_window
        out_sols = out_sols.at[t].set(jnp.where(ok, best_sol, 0))
        out_scores = out_scores.at[t].set(jnp.where(ok, best_score, -jnp.inf))
        out_valid = out_valid.at[t].set(ok)
        # per-instance scalar index -> one-hot select (no batched scatter)
        active = active & (jnp.arange(pool) != best)
        n_parent_bans = jnp.sum(ban_r[best] >= 0).astype(jnp.int32)
        ban_slot = jnp.minimum(n_parent_bans, k - 1)
        slot_hot = jnp.arange(k) == ban_slot                   # [k]

        # ---- dual upper bound per candidate child.  Child r bans parent
        # pair (r, best_sol[r]) (and every col >= nC when that col is
        # augmented) and forces rows < r to the parent solution.  All of
        # those only RAISE entries of the minimized effective matrix, so the
        # parent duals stay feasible and certify
        #   child_best <= parent_best - min_{allowed j} slack[r, j].
        a_eff = -build_eff(forced[best], ban_r[best], ban_c[best],
                           ban_aug[best])                       # minimized
        slack = a_eff - us[best][1:, None] - vs[best][None, 1:]  # [n, n]
        child_ban = cols[None, :] == best_sol[:, None]
        if not all_cols_real:
            child_ban |= (best_sol[:, None] >= nC) & (cols[None, :] >= nC)
        INFB = jnp.asarray(jnp.finfo(cost.dtype).max / 8, cost.dtype)
        gap = jnp.min(jnp.where(child_ban, INFB,
                                jnp.maximum(slack, 0.0)), axis=1)  # [n]
        # degraded lanes (capped augment walk, f32 drift) can carry broken
        # duals; a clearly infeasible slack disables the bound for this node
        duals_ok = jnp.min(jnp.where(child_ban, 0.0, slack)) > -1e-2
        gap = jnp.where(duals_ok, gap, 0.0)
        ub = best_score - gap                                   # [n]

        # valid candidate children: free rows inside the real-assignment
        # partition range whose bound survives the prune window.  When the
        # cap binds, keep the HIGHEST-BOUND children — the wave width, not
        # the validity mask, is what the vmapped Hungarian pays for.
        cand_valid = ok & (forced[best][cand_rows] < 0) & (
            cand_rows < partition_max)                          # [pb_full]
        if prune_window is not None:
            cand_valid &= ub[cand_rows] >= root_score - prune_window
        n_valid_log = n_valid_log.at[t].set(
            jnp.sum(cand_valid).astype(jnp.int32))
        if pb < pb_full:
            key_ub = jnp.where(cand_valid, ub[cand_rows], -jnp.inf)
            order = jnp.argsort(-key_ub, stable=True).astype(jnp.int32)
            child_rows = order[:pb]                             # [pb]
            child_valid = cand_valid[child_rows]
        else:
            child_rows = cand_rows
            child_valid = cand_valid

        # expand: child r = parent constraints + rows<r forced to best_sol,
        # row r banned from best_sol[r].  All children of an iteration are
        # independent — solve them in ONE vmapped batch (the sequential
        # child loop made a murty call k*partition_bound sequential
        # Hungarian solves; this is k).  Iteration t's children occupy pool
        # slots [1 + t*pb, 1 + (t+1)*pb): slot usage is deterministic, so no
        # free-slot bookkeeping is needed (pool = k*pb + 1 by construction).
        rows = jnp.arange(n)
        f_children = jnp.where(
            (rows[None, :] < child_rows[:, None]) & (forced[best][None, :] < 0),
            best_sol[None, :], forced[best][None, :])           # [pb, n]
        br_c = jnp.where(slot_hot[None, :], child_rows[:, None],
                         ban_r[best][None, :])
        bc_c = jnp.where(slot_hot[None, :], best_sol[child_rows][:, None],
                         ban_c[best][None, :])
        aug_val = (jnp.zeros((pb,), bool) if all_cols_real
                   else best_sol[child_rows] >= nC)
        baug_c = jnp.where(slot_hot[None, :], aug_val[:, None],
                           ban_aug[best][None, :])
        sols_c, tots_c, us_c, vs_c = jax.vmap(solve)(
            f_children, br_c, bc_c, baug_c)
        tots_c = jnp.where(child_valid, tots_c, -jnp.inf)

        start = 1 + t * pb
        upd = lambda arr, new: jax.lax.dynamic_update_slice_in_dim(
            arr, new, start, axis=0)
        forced = upd(forced, f_children)
        ban_r = upd(ban_r, br_c)
        ban_c = upd(ban_c, bc_c)
        ban_aug = upd(ban_aug, baug_c)
        sols = upd(sols, sols_c)
        scores = upd(scores, tots_c)
        active = upd(active, child_valid)
        us = upd(us, us_c)
        vs = upd(vs, vs_c)
        return (forced, ban_r, ban_c, ban_aug, sols, scores, active, us, vs,
                out_sols, out_scores, out_valid, n_valid_log)

    carry = (forced0, ban_r0, ban_c0, ban_aug0, sol0, score0, active0,
             us0, vs0, out_sols, out_scores, out_valid, nvalid0)
    # the last iteration only needs to EXTRACT its best — its children are
    # never read (out slots are full), so skip the k-th expansion wave
    # entirely (one of k vmapped-Hungarian waves, a 1/k cost cut)
    carry = jax.lax.fori_loop(0, k - 1, iteration, carry)
    (forced, ban_r, ban_c, ban_aug, sols, scores, active, _, _,
     out_sols, out_scores, out_valid, n_valid_log) = carry
    best = jnp.argmax(jnp.where(active, scores, -jnp.inf)).astype(jnp.int32)
    ok = active[best] & (scores[best] > NEG / 2)
    if prune_window is not None:
        ok &= scores[best] >= root_score - prune_window
    out_sols = out_sols.at[k - 1].set(jnp.where(ok, sols[best], 0))
    out_scores = out_scores.at[k - 1].set(
        jnp.where(ok, scores[best], -jnp.inf))
    out_valid = out_valid.at[k - 1].set(ok)
    if return_nvalid:
        return out_sols, out_scores, out_valid, n_valid_log[:k - 1]
    return out_sols, out_scores, out_valid


def second_best_bound(cost, sol, tot, u, v, real_rows, real_cols=None):
    """Dual upper bound on the SECOND-best real-block assignment — the max
    over candidate child rows of murty's root-wave child bound (identical
    slack/duals_ok arithmetic to murty's iteration).  ``ub2 < best -
    window`` certifies the lane admits only one in-window hypothesis."""
    n = cost.shape[-1]
    nC = jnp.asarray(n if real_cols is None else real_cols)
    cols = jnp.arange(n)
    a_eff = -cost
    slack = a_eff - u[1:, None] - v[None, 1:]
    child_ban = cols[None, :] == sol[:, None]
    child_ban |= (sol[:, None] >= nC) & (cols[None, :] >= nC)
    INFB = jnp.asarray(jnp.finfo(cost.dtype).max / 8, cost.dtype)
    gap = jnp.min(jnp.where(child_ban, INFB,
                            jnp.maximum(slack, 0.0)), axis=1)       # [n]
    duals_ok = jnp.min(jnp.where(child_ban, 0.0, slack)) > -1e-2
    gap = jnp.where(duals_ok, gap, 0.0)
    partition_max = jnp.where(jnp.asarray(real_rows) >= n, n - 1, real_rows)
    cand = cols < partition_max
    return jnp.max(jnp.where(cand, tot - gap, -jnp.inf))


def ambiguous_lanes(tables, real_rows, real_cols, prune_window):
    """[P] bool — which lanes' dual bound admits a 2nd in-window hypothesis
    (the murty_gated lane classifier, exposed for instrumentation)."""
    sols, tots, us, vs = jax.vmap(_hungarian_uv)(tables)
    ub2 = jax.vmap(
        lambda c, s, t, u, v, nr: second_best_bound(c, s, t, u, v, nr,
                                                    real_cols)
    )(tables, sols, tots, us, vs, real_rows)
    return (tots > NEG / 2) & (ub2 >= tots - prune_window)


def murty_gated(tables: jax.Array, k: int, real_rows: jax.Array,
                real_cols=None, child_cap: int | None = None,
                prune_window: float | None = None,
                budget: int | None = None,
                return_overflow: bool = False):
    """Batched :func:`murty` with per-lane ambiguity gating.

    MH-FastSLAM runs murty vmapped over every particle lane, but on
    low-ambiguity data most lanes provably admit only ONE hypothesis inside
    ``prune_window``: the root Hungarian's dual potentials certify
    ``second_best <= best - min_r gap_r`` (the same child bound murty's
    waves use), so when that bound already falls outside the window the
    whole expansion returns just the root — k-1 vmapped-Hungarian waves of
    work for a foregone conclusion.  This wrapper

    1. solves only the ROOT assignment for all ``P`` lanes,
    2. classifies each lane *ambiguous* iff its dual second-best upper
       bound is within ``prune_window`` of its best score,
    3. gathers the (at most ``budget``) most-ambiguous lanes, runs the full
       murty expansion on that small batch, and scatters the results back;
       every other lane gets the root as its single valid hypothesis.

    EXACT (same outputs as the plain vmapped murty) for every
    non-ambiguous lane — murty's own window pruning would invalidate all
    their children — and for every ambiguous lane within the budget.  Only
    ambiguous lanes beyond the budget are truncated to their root
    hypothesis; they are the LEAST ambiguous of the active set (lanes are
    ranked by how close the second-best bound comes to the best), and
    ``return_overflow`` exposes how many lanes were truncated so callers
    can size the budget from data.

    Requires ``prune_window`` (the gate is meaningless without it).
    ``real_rows``: [P] int; ``real_cols``: scalar (shared across lanes).
    Returns ``(assignments [P, k, n], scores [P, k], valid [P, k])``
    (+ ``overflow`` scalar int32 if requested).
    """
    assert prune_window is not None, "murty_gated requires prune_window"
    P, n, _ = tables.shape
    run_all = budget is None or budget >= P or k <= 1

    if run_all:
        das, scores, valid = jax.vmap(
            lambda t, nr: murty(t, k, real_rows=nr, real_cols=real_cols,
                                child_cap=child_cap,
                                prune_window=prune_window)
        )(tables, real_rows)
        if return_overflow:
            return das, scores, valid, jnp.int32(0)
        return das, scores, valid

    sols, tots, us, vs = jax.vmap(_hungarian_uv)(tables)
    root_ok = tots > NEG / 2
    ub2 = jax.vmap(
        lambda c, s, t, u, v, nr: second_best_bound(c, s, t, u, v, nr,
                                                    real_cols)
    )(tables, sols, tots, us, vs, real_rows)
    ambiguous = root_ok & (ub2 >= tots - prune_window)

    # most-ambiguous lanes first: rank by closeness of the 2nd-best bound
    amb_key = jnp.where(ambiguous, ub2 - tots, -jnp.inf)
    _, sel = jax.lax.top_k(amb_key, budget)                 # [A]
    sel_amb = jnp.take(ambiguous, sel)
    das_s, sc_s, va_s = jax.vmap(
        lambda t, nr: murty(t, k, real_rows=nr, real_cols=real_cols,
                            child_cap=child_cap, prune_window=prune_window)
    )(jnp.take(tables, sel, axis=0), jnp.take(real_rows, sel))

    # defaults: root as the single valid hypothesis (identical to what the
    # full murty returns for a lane whose children all fail the window)
    das0 = jnp.zeros((P, k, n), jnp.int32)
    das0 = das0.at[:, 0, :].set(jnp.where(root_ok[:, None], sols, 0))
    scores0 = jnp.full((P, k), -jnp.inf, tables.dtype)
    scores0 = scores0.at[:, 0].set(jnp.where(root_ok, tots, -jnp.inf))
    valid0 = jnp.zeros((P, k), bool).at[:, 0].set(root_ok)

    eq = sel[None, :] == jnp.arange(P)[:, None]             # [P, A]
    hit = jnp.any(eq & sel_amb[None, :], axis=1)
    pos = jnp.argmax(eq, axis=1)
    das = jnp.where(hit[:, None, None], jnp.take(das_s, pos, axis=0), das0)
    scores = jnp.where(hit[:, None], jnp.take(sc_s, pos, axis=0), scores0)
    valid = jnp.where(hit[:, None], jnp.take(va_s, pos, axis=0), valid0)
    if return_overflow:
        overflow = (jnp.sum(ambiguous) - jnp.sum(sel_amb)).astype(jnp.int32)
        return das, scores, valid, overflow
    return das, scores, valid


def brute_force_assignments(cost: np.ndarray, k: int | None = None):
    """All assignments sorted by score desc (NumPy test oracle).

    Reference: BruteForceAssignment.hpp:40-88.
    """
    n = cost.shape[0]
    results = []
    for perm in itertools.permutations(range(n)):
        score = sum(cost[i, perm[i]] for i in range(n))
        results.append((score, list(perm)))
    results.sort(key=lambda t: -t[0])
    if k is not None:
        results = results[:k]
    scores = np.array([r[0] for r in results])
    perms = np.array([r[1] for r in results])
    return perms, scores


def cost_partition(gate: jax.Array, max_iters: int | None = None):
    """Bipartite connected-component partitioning of a gated cost table.

    Replaces ``CostMatrixGeneral::partition`` (CostMatrix.cpp:92-157, built
    on boost::graph connected_components) with fixed-iteration min-label
    propagation: rows and columns start with unique labels and repeatedly
    take the minimum label over their gated neighbors.  ``ceil(log2(R+C))``
    doublings suffice because the propagation distance doubles each pass.

    Args:
        gate: [R, C] bool — entry (r, c) is nonzero/above threshold.
        max_iters: propagation rounds; default covers the worst-case chain.

    Returns:
        (row_label [R], col_label [C]) int32 component ids.  A row/column
        with no gated entry keeps its own singleton label (the reference
        gives those their own partition too).  Batched via vmap.
    """
    R, C = gate.shape
    if max_iters is None:
        import math

        max_iters = max(1, math.ceil(math.log2(R + C)) + 1)
    row = jnp.arange(R, dtype=jnp.int32)
    col = jnp.arange(R, R + C, dtype=jnp.int32)
    big = jnp.int32(R + C)

    def step(_, labels):
        row, col = labels
        # row <- min over gated cols; col <- min over gated rows
        col_b = jnp.where(gate, col[None, :], big)
        row_new = jnp.minimum(row, jnp.min(col_b, axis=1))
        row_b = jnp.where(gate, row_new[:, None], big)
        col_new = jnp.minimum(col, jnp.min(row_b, axis=0))
        return row_new, col_new

    row, col = jax.lax.fori_loop(0, max_iters, step, (row, col))
    return row, col


def cost_reduce(cost: jax.Array, lim: float):
    """Forced-assignment reduction of a square cost table.

    Replaces ``CostMatrix::reduce`` (CostMatrix.cpp:263-369, the
    ``minVal=true`` floor-threshold mode used by FastSLAM DA,
    FastSLAM.hpp:493-499): an entry is a potential match if it exceeds the
    floor ``lim``; a (row, col) pair where that entry is the ONLY match in
    both its row and its column becomes a FIXED assignment (single pass —
    the reference does not iterate).  If exactly one free pair remains, it
    is fixed too (CostMatrix.cpp:332-337).

    Returns:
        fixed [n] int32 — column fixed for each row (-1 = row remains in the
        reduced problem); row_free [n] bool; col_free [n] bool.  The reduced
        matrix is ``cost`` masked to free rows/cols (callers keep the full
        shape and mask, the fixed-shape idiom).  Batched via vmap.
    """
    n = cost.shape[-1]
    ok = cost > lim
    row_cnt = jnp.sum(ok, axis=1)
    col_cnt = jnp.sum(ok, axis=0)
    # entries that are the single above-lim entry of BOTH row and column
    single = ok & (row_cnt[:, None] == 1) & (col_cnt[None, :] == 1)
    col_of = jnp.argmax(single, axis=1).astype(jnp.int32)
    has = jnp.any(single, axis=1)
    fixed = jnp.where(has, col_of, -1)
    row_free = ~has
    col_free = ~jnp.any(single, axis=0)

    # n_reduced == 1 quirk: the lone remaining pair is forced
    one_left = (jnp.sum(row_free) == 1) & (jnp.sum(col_free) == 1)
    last_row = jnp.argmax(row_free).astype(jnp.int32)
    last_col = jnp.argmax(col_free).astype(jnp.int32)
    fixed = jnp.where(
        one_left & (jnp.arange(n) == last_row), last_col, fixed)
    row_free = row_free & ~(one_left & (jnp.arange(n) == last_row))
    col_free = col_free & ~(one_left & (jnp.arange(n) == last_col))
    return fixed, row_free, col_free


def permutations_lexicographic(n_m: int, n_z: int) -> np.ndarray:
    """All landmark->measurement association vectors in lexicographic order.

    Replaces ``PermutationLexicographic`` (PermutationLexicographic.hpp:44-79):
    each of the ``n_m`` landmarks is assigned one of the ``n_z`` measurements
    or ``n_z`` (= missed detection); measurements not claimed are clutter.
    Measurement indices must be distinct among landmarks.  Returns an
    ``[n_assignments, n_m]`` int array, ordered lexicographically — usable
    as a precomputed enumeration tensor for small partitions
    (RBPHDFilter.hpp:961-988) and as a test oracle.

    NumPy/host-side by design: the output feeds jitted code as a constant.
    """
    out = []

    def rec(prefix, used):
        if len(prefix) == n_m:
            out.append(list(prefix))
            return
        for c in range(n_z + 1):
            if c < n_z and c in used:
                continue
            rec(prefix + [c], used | ({c} if c < n_z else set()))

    rec([], set())
    return np.asarray(out, np.int32)


def matrix_permanent(a: jax.Array) -> jax.Array:
    """Permanent of an [n, n] matrix via the Ryser formula.

    Reference: MatrixPermanent.hpp:39-68 (Nijenhuis-Wilf).  O(2^n * n); fine
    for the reference's tested range n <= 12.
    """
    n = a.shape[-1]
    subsets = jnp.arange(1, 1 << n)
    bits = ((subsets[:, None] >> jnp.arange(n)[None, :]) & 1).astype(a.dtype)
    row_sums = jnp.matmul(bits, a.T, precision=jax.lax.Precision.HIGHEST)
    prods = jnp.prod(row_sums, axis=-1)
    signs = jnp.where((n - jnp.sum(bits, axis=-1)) % 2 == 0, 1.0, -1.0)
    return jnp.sum(signs * prods)
