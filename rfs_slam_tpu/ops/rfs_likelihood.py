"""Exact RFS measurement likelihood via a subset-sum dynamic program.

The reference evaluates the multi-feature RFS measurement likelihood

    L = sum over all landmark<->measurement matchings A of
        prod_{(r,c) in A} L[r,c] * prod_{r unmatched} (1 - Pd_r)
        * prod_{c unmatched} clutter_c

by partitioning the gated likelihood table into bipartite connected
components and, per partition, either enumerating all assignments
(nRows + nCols <= 8) or summing the top-200 assignments from Murty's
algorithm (reference: RBPHDFilter.hpp:821-997, CostMatrix.cpp:92-157,
MurtyAlgorithm.cpp).

Here both paths are replaced by one dense subset-sum DP over measurement
columns, which computes the FULL sum exactly in O(E * 2^Zd * Zd) fully
vectorized work (no partitioning needed — the sum factorizes over connected
components automatically).  This is *more* exact than the reference's
Murty-200 truncation for large partitions.  Columns beyond the compile-time
cap ``z_dp_max`` are kept as pure-clutter factors (ranked by their best
gated likelihood), the analog of the reference's truncation.

Reference quirk reproduced deliberately: rows that end up in an all-zero
partition (no gated measurement for that eval point) multiply the likelihood
by ``Pd_r`` — not ``1 - Pd_r`` (RBPHDFilter.hpp:905-917).  We reproduce this
by flipping the DP's missed-detection factor to ``Pd_r`` for support-less
rows, which is exactly equivalent because such a row always forms its own
singleton partition.

Underflow control: each row and column is rescaled by its dominant factor
(every matching contains exactly one factor per row and one per column), so
the DP runs near unity and the scales are restored in log space — the
float32 substitute for the reference's double-precision products.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-30


def rfs_log_likelihood(
    L: jax.Array,            # [P, E, Z] gated likelihood * Pd (0 where gated out)
    pd: jax.Array,           # [P, E]  eval-point probability of detection
    row_active: jax.Array,   # [P, E] bool
    clutter: jax.Array,      # [P, Z] per-measurement clutter intensity
    z_active: jax.Array,     # [P, Z] or [Z] bool
    log_clutter_integral,    # scalar: log of clutterIntensityIntegral
    z_dp_max: int = 12,
) -> jax.Array:
    """Log RFS measurement likelihood per particle, [P]."""
    P, E, Z = L.shape
    if z_active.ndim == 1:
        z_active = jnp.broadcast_to(z_active[None, :], (P, Z))
    clutter = jnp.broadcast_to(clutter, (P, Z))

    L = jnp.where(row_active[:, :, None] & z_active[:, None, :], L, 0.0)

    # ---- column selection: keep the z_dp_max best-supported columns in the DP
    support = jnp.max(L, axis=1)                       # [P, Z]
    has_support = (support > 0.0) & z_active
    Zd = min(Z, z_dp_max)
    sel_score = jnp.where(has_support, support, -jnp.inf)
    _, sel_idx = jax.lax.top_k(sel_score, Zd)           # [P, Zd]
    sel_valid = jnp.take_along_axis(has_support, sel_idx, axis=1)

    L_sel = jnp.take_along_axis(L, sel_idx[:, None, :], axis=2)      # [P,E,Zd]
    L_sel = jnp.where(sel_valid[:, None, :], L_sel, 0.0)
    clut_sel = jnp.take_along_axis(clutter, sel_idx, axis=1)         # [P,Zd]

    # active columns NOT in the DP contribute their clutter factor exactly
    # (they have no gated landmark, or were truncated — reference analog:
    # zero partitions and Murty truncation)
    # one-hot reduce, not a batched scatter
    in_dp = jnp.any(
        (sel_idx[:, :, None] == jnp.arange(Z)) & sel_valid[:, :, None], axis=1
    )
    log_extra = jnp.sum(
        jnp.where(z_active & ~in_dp, jnp.log(jnp.maximum(clutter, _EPS)), 0.0),
        axis=1,
    )

    # ---- reference zero-partition quirk: support-less rows use Pd, not 1-Pd
    row_support = jnp.max(L_sel, axis=2) > 0.0          # [P, E]
    pd_eff = jnp.where(row_support, pd, 1.0 - pd)
    miss = jnp.where(row_active, 1.0 - pd_eff, 1.0)     # inactive rows: factor 1
    L_sel = jnp.where(row_active[:, :, None], L_sel, 0.0)

    # ---- row scaling: a_r = max(miss_r, max_c L[r, c])
    a = jnp.maximum(jnp.maximum(miss, jnp.max(L_sel, axis=2)), _EPS)
    a = jnp.where(row_active, a, 1.0)
    L1 = L_sel / a[:, :, None]
    miss1 = miss / a

    # ---- column scaling: b_c = max(clutter_c, max_r L1[r, c])
    b = jnp.maximum(jnp.maximum(clut_sel, jnp.max(L1, axis=1)), _EPS)
    b = jnp.where(sel_valid, b, 1.0)
    L2 = L1 / b[:, None, :]
    clut1 = jnp.where(sel_valid, clut_sel / b, 1.0)     # invalid cols: factor 1

    # ---- subset-sum DP over the Zd selected columns
    # state[S] = sum over matchings of processed rows using exactly column set S
    state = jnp.zeros((P,) + (2,) * Zd, L.dtype)
    state = state.reshape(P, -1).at[:, 0].set(1.0).reshape((P,) + (2,) * Zd)

    def row_step(r, state):
        L2_r = jax.lax.dynamic_index_in_dim(L2, r, axis=1, keepdims=False)  # [P,Zd]
        miss_r = jax.lax.dynamic_index_in_dim(miss1, r, axis=1, keepdims=False)
        new = state * miss_r.reshape((P,) + (1,) * Zd)
        for c in range(Zd):
            axis = 1 + c
            sl = jax.lax.slice_in_dim(state, 0, 1, axis=axis)  # S without col c
            shifted = jnp.concatenate([jnp.zeros_like(sl), sl], axis=axis)
            lc = L2_r[:, c].reshape((P,) + (1,) * Zd)
            new = new + shifted * lc
        return new

    state = jax.lax.fori_loop(0, E, row_step, state)

    # ---- weight unmatched columns by scaled clutter and sum over subsets
    # (along each column axis, index 0 = "not matched" gets the clutter factor)
    w = jnp.ones((P,) + (1,) * Zd, L.dtype)
    for c in range(Zd):
        fac = jnp.stack([clut1[:, c], jnp.ones_like(clut1[:, c])], axis=1)
        fac = fac.reshape((P,) + (1,) * c + (2,) + (1,) * (Zd - c - 1))
        w = w * fac
    total = jnp.sum((state * w).reshape(P, -1), axis=1)

    log_lik = (
        jnp.log(jnp.maximum(total, _EPS))
        + jnp.sum(jnp.log(a), axis=1)
        + jnp.sum(jnp.log(b), axis=1)
        + log_extra
        - log_clutter_integral
    )
    return log_lik
