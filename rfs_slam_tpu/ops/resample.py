"""Low-variance (systematic) resampling as batched gathers.

Reference: ``ParticleFilter::resample`` (ParticleFilter.hpp:399-492) —
normalize weights, effective-sample-size gate, systematic sampling of the
cumulative weight array, then copy-on-demand of particle data.  Here the
copy-on-demand object shuffle becomes a single gather along the particle axis
(of poses, log-weights, and every per-particle map array), which under a
particle-sharded ``NamedSharding`` lowers to the one all-to-all collective of
the whole filter step.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def normalize_log_weights(log_w: jax.Array) -> jax.Array:
    """log-domain equivalent of ParticleFilter::normalizeWeights
    (ParticleFilter.hpp:352-363)."""
    return log_w - jax.scipy.special.logsumexp(log_w)


def effective_count(log_w: jax.Array) -> jax.Array:
    """N_eff = 1 / sum(w_i^2) on normalized weights (ParticleFilter.hpp:404-415)."""
    log_wn = normalize_log_weights(log_w)
    return jnp.exp(-jax.scipy.special.logsumexp(2.0 * log_wn))


def systematic_ancestors(key: jax.Array, log_w: jax.Array, n: int) -> jax.Array:
    """Systematic-resampling ancestor indices.

    One uniform draw offsets an evenly spaced comb over the cumulative weight
    distribution (ParticleFilter.hpp:420-445).
    """
    log_wn = normalize_log_weights(log_w)
    w = jnp.exp(log_wn)
    cum = jnp.cumsum(w)
    u0 = jax.random.uniform(key, (), dtype=w.dtype)
    pts = (u0 + jnp.arange(n, dtype=w.dtype)) / n
    anc = jnp.searchsorted(cum, pts, side="left")
    return jnp.clip(anc, 0, log_w.shape[0] - 1).astype(jnp.int32)


def maybe_resample(
    key: jax.Array,
    log_w: jax.Array,
    ess_threshold,
    allow: jax.Array | bool = True,
    force: jax.Array | bool = False,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Gate + sample; returns ``(ancestors, new_log_w, did_resample)``.

    ``allow`` encodes the min-updates / min-measurements gating of the filter
    (RBPHDFilter.hpp:526-539); ``force`` the forced resample of MH-FastSLAM
    (FastSLAM.hpp:733-737).  When no resample happens, ancestors is the
    identity and weights are normalized (reference behavior: update() calls
    normalizeWeights if resample didn't occur).
    """
    n = log_w.shape[0]
    ess = effective_count(log_w)
    do = jnp.asarray(allow) & (force | (ess <= ess_threshold))
    anc = systematic_ancestors(key, log_w, n)
    identity = jnp.arange(n, dtype=jnp.int32)
    ancestors = jnp.where(do, anc, identity)
    new_log_w = jnp.where(do, jnp.zeros_like(log_w) - jnp.log(n),
                          normalize_log_weights(log_w))
    return ancestors, new_log_w, do


def gather_particles(tree, ancestors: jax.Array):
    """Gather every per-particle array (leading axis P) by ancestor index.

    The equivalent of ``Particle::copy()``'s deep map copy
    (ParticleFilter.hpp:446-479): one gather covering poses and the full map
    SoA.  Containers with plane-major storage (GMState, BirthCandidates)
    expose ``gather_p`` and are gathered along their own particle axis.
    """
    def g(a):
        if hasattr(a, "gather_p"):
            return a.gather_p(ancestors)
        return jnp.take(a, ancestors, axis=0)

    return jax.tree_util.tree_map(
        g, tree, is_leaf=lambda x: hasattr(x, "gather_p")
    )
