"""Tests for Gaussian-mixture maintenance ops (merge/prune/compact/append)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from rfs_slam_tpu.core.state import GMState
from rfs_slam_tpu.ops import gm as gm_ops


def make_gm(means, covs, ws, capacity=8):
    n = len(means)
    d = len(means[0])
    g = GMState.empty(1, capacity, d)
    mean = np.zeros((1, capacity, d), np.float32)
    cov = np.tile(np.eye(d, dtype=np.float32), (1, capacity, 1, 1))
    w = np.zeros((1, capacity), np.float32)
    alive = np.zeros((1, capacity), bool)
    for i, (m, c, wi) in enumerate(zip(means, covs, ws)):
        mean[0, i] = m
        cov[0, i] = c
        w[0, i] = wi
        alive[0, i] = True
    return GMState.from_dense(jnp.asarray(mean), jnp.asarray(cov),
                              jnp.asarray(w), jnp.asarray(w),
                              jnp.asarray(alive))


def test_prune_keeps_geq_threshold():
    g = make_gm([[0, 0], [1, 1], [2, 2]], [np.eye(2)] * 3, [0.5, 0.2, 0.05])
    out = gm_ops.prune(g, 0.2)
    np.testing.assert_array_equal(np.asarray(out.alive[0, :3]), [True, True, False])


def test_compact_sorts_by_weight():
    g = make_gm([[0, 0], [1, 1], [2, 2]], [np.eye(2)] * 3, [0.1, 0.9, 0.5])
    out = gm_ops.compact(g, 2)
    np.testing.assert_allclose(np.asarray(out.w[0]), [0.9, 0.5])
    np.testing.assert_allclose(np.asarray(out.mean_dense[0, 0]), [1, 1])
    assert bool(np.all(np.asarray(out.alive[0])))


def test_merge_moment_match():
    # two overlapping Gaussians merge per GaussianMixture.hpp:455-460
    S = 0.1 * np.eye(2)
    g = make_gm([[0.0, 0.0], [0.2, 0.0]], [S, S], [0.6, 0.4])
    out = gm_ops.merge(g, threshold=2.0, f_inflation=1.5)
    alive = np.asarray(out.alive[0])
    assert alive.sum() == 1
    i = int(np.argmax(alive))
    w = float(out.w[0, i])
    np.testing.assert_allclose(w, 1.0, rtol=1e-5)
    xm = np.asarray(out.mean_dense[0, i])
    np.testing.assert_allclose(xm, [0.08, 0.0], atol=1e-6)
    d1 = xm - np.array([0.0, 0.0])
    d2 = xm - np.array([0.2, 0.0])
    Sm = (0.6 * (S + 1.5 * np.outer(d1, d1)) + 0.4 * (S + 1.5 * np.outer(d2, d2)))
    np.testing.assert_allclose(np.asarray(out.cov_dense[0, i]), Sm, rtol=1e-4)
    assert float(out.w_prev[0, i]) == 0.0


def test_merge_respects_gate():
    S = 0.01 * np.eye(2)
    g = make_gm([[0.0, 0.0], [5.0, 0.0]], [S, S], [0.5, 0.5])
    out = gm_ops.merge(g, threshold=1.0, f_inflation=1.0)
    assert int(np.asarray(out.alive[0]).sum()) == 2


def test_merge_chain_converges():
    # three Gaussians in a line, pairwise-mergeable: should end as one
    S = 1.0 * np.eye(2)
    g = make_gm([[0.0, 0.0], [0.5, 0.0], [1.0, 0.0]], [S] * 3, [0.3, 0.3, 0.3])
    out = gm_ops.merge(g, threshold=3.0, f_inflation=1.0)
    assert int(np.asarray(out.alive[0]).sum()) == 1
    np.testing.assert_allclose(float(out.w[0][np.asarray(out.alive[0])][0]), 0.9, rtol=1e-5)


def test_merge_conserves_mass_in_broken_chain():
    """k-x gated, x-j gated, k-j NOT gated: the parallel pass must not let
    x absorb j while k absorbs x's pre-merge weight — that loses j's mass
    (round-4 bug: both implementations dropped w_j in this configuration).
    The safe-absorber rule defers x's absorption to a later pass."""
    S = 0.04 * np.eye(2)  # sigma = 0.2
    # 0 at x=0, 1 at x=0.5, 2 at x=1.0; threshold 3 => d<=0.6 merges
    g = make_gm([[0.0, 0.0], [0.5, 0.0], [1.0, 0.0]], [S] * 3,
                [0.5, 0.3, 0.2])
    d01 = 0.5 / 0.2
    assert d01 <= 3.0 and (1.0 / 0.2) > 3.0
    out = gm_ops.merge(g, threshold=3.0, f_inflation=1.0)
    total = float(np.asarray(out.w[0])[np.asarray(out.alive[0])].sum())
    np.testing.assert_allclose(total, 1.0, rtol=1e-5)


def test_merge_conserves_mass_random(rng):
    """Total alive weight is invariant under merge, any configuration."""
    for trial in range(5):
        P, M = 3, 24
        mean = rng.normal(size=(P, M, 2)).astype(np.float32) * 1.5
        S = np.broadcast_to(0.25 * np.eye(2, dtype=np.float32), (P, M, 2, 2))
        w = rng.uniform(0.1, 1.0, size=(P, M)).astype(np.float32)
        alive = rng.uniform(size=(P, M)) < 0.8
        g = make_gm_raw(mean, S, w, alive)
        before = (w * alive).sum(axis=1)
        out = gm_ops.merge(g, threshold=1.5, f_inflation=1.5)
        after = np.asarray(
            np.where(np.asarray(out.alive), np.asarray(out.w), 0.0)
        ).sum(axis=1)
        np.testing.assert_allclose(after, before, rtol=1e-4,
                                   err_msg=f"trial {trial}")


def make_gm_raw(mean, cov, w, alive):
    from rfs_slam_tpu.core import planar

    return GMState(
        mean=planar.pack_vec(jnp.asarray(mean)),
        cov=planar.pack_sym(jnp.asarray(cov)),
        w=jnp.asarray(w), w_prev=jnp.zeros_like(jnp.asarray(w)),
        alive=jnp.asarray(alive),
    )


def test_append_compacts():
    g = make_gm([[0, 0]], [np.eye(2)], [0.5], capacity=2)
    from rfs_slam_tpu.core import planar
    new_mean = planar.pack_vec(jnp.asarray([[[3.0, 3.0], [4.0, 4.0]]]))
    new_cov = planar.pack_sym(jnp.broadcast_to(jnp.eye(2), (1, 2, 2, 2)))
    new_w = jnp.asarray([[0.8, 0.1]])
    new_alive = jnp.asarray([[True, True]])
    out = gm_ops.append(g, new_mean, new_cov, new_w, new_alive)
    # capacity 2: keeps 0.8 and 0.5, drops 0.1
    np.testing.assert_allclose(np.asarray(out.w[0]), [0.8, 0.5])


def test_replace_weakest_matches_append_compact(rng):
    """replace_weakest == top-capacity of the union (= append + compact),
    compared as weight multisets + exact member sets (weights distinct)."""
    from rfs_slam_tpu.core import planar
    P, M, K = 4, 12, 5
    mean = planar.pack_vec(jnp.asarray(rng.normal(size=(P, M, 2)), jnp.float32))
    cov = planar.pack_sym(jnp.broadcast_to(jnp.eye(2, dtype=jnp.float32),
                                           (P, M, 2, 2)))
    w = jnp.asarray(rng.uniform(0.01, 1.0, size=(P, M)), jnp.float32)
    alive = jnp.asarray(rng.uniform(size=(P, M)) < 0.8)
    g = gm_ops.GMState(mean=mean, cov=cov, w=w, w_prev=jnp.zeros_like(w),
                       alive=alive)
    n_mean = planar.pack_vec(jnp.asarray(rng.normal(size=(P, K, 2)),
                                         jnp.float32))
    n_cov = planar.pack_sym(jnp.broadcast_to(
        jnp.eye(2, dtype=jnp.float32) * 2.0, (P, K, 2, 2)))
    n_w = jnp.asarray(rng.uniform(0.01, 1.0, size=(P, K)), jnp.float32)
    n_alive = jnp.asarray(rng.uniform(size=(P, K)) < 0.7)

    ref = gm_ops.append(g, n_mean, n_cov, n_w, n_alive)
    out = gm_ops.replace_weakest(g, n_mean, n_cov, n_w, n_alive)
    assert out.w.shape == (P, M)
    for p in range(P):
        ref_a = np.asarray(ref.alive[p])
        out_a = np.asarray(out.alive[p])
        assert ref_a.sum() == out_a.sum()
        rw = np.sort(np.asarray(ref.w[p])[ref_a])
        ow = np.sort(np.asarray(out.w[p])[out_a])
        np.testing.assert_allclose(ow, rw, rtol=1e-6)
        # members match exactly: sort means of alive slots by weight
        r_ord = np.argsort(np.asarray(ref.w[p])[ref_a])
        o_ord = np.argsort(np.asarray(out.w[p])[out_a])
        rm = np.asarray(planar.unpack_vec(ref.mean)[p])[ref_a][r_ord]
        om = np.asarray(planar.unpack_vec(out.mean)[p])[out_a][o_ord]
        np.testing.assert_allclose(om, rm, rtol=1e-6)
        # inserted entries carry w_prev = 0, survivors keep theirs
        np.testing.assert_allclose(
            np.sort(np.asarray(out.w_prev[p])[out_a]),
            np.sort(np.asarray(ref.w_prev[p])[ref_a]), rtol=1e-6)


def test_replace_weakest_more_new_than_capacity(rng):
    from rfs_slam_tpu.core import planar
    P, M, K = 2, 4, 7
    mean = planar.pack_vec(jnp.asarray(rng.normal(size=(P, M, 2)), jnp.float32))
    cov = planar.pack_sym(jnp.broadcast_to(jnp.eye(2, dtype=jnp.float32),
                                           (P, M, 2, 2)))
    w = jnp.asarray(rng.uniform(0.01, 1.0, size=(P, M)), jnp.float32)
    g = gm_ops.GMState(mean=mean, cov=cov, w=w, w_prev=jnp.zeros_like(w),
                       alive=jnp.ones((P, M), bool))
    n_mean = planar.pack_vec(jnp.asarray(rng.normal(size=(P, K, 2)), jnp.float32))
    n_cov = planar.pack_sym(jnp.broadcast_to(jnp.eye(2, dtype=jnp.float32),
                                             (P, K, 2, 2)))
    n_w = jnp.asarray(rng.uniform(0.01, 1.0, size=(P, K)), jnp.float32)
    n_alive = jnp.ones((P, K), bool)
    ref = gm_ops.append(g, n_mean, n_cov, n_w, n_alive)
    out = gm_ops.replace_weakest(g, n_mean, n_cov, n_w, n_alive)
    for p in range(P):
        np.testing.assert_allclose(
            np.sort(np.asarray(out.w[p])[np.asarray(out.alive[p])]),
            np.sort(np.asarray(ref.w[p])[np.asarray(ref.alive[p])]), rtol=1e-6)


# ------------------------------------------------- float64 oracle checks
def _random_dense_gm(rng, P, M, D, n_alive, spread=3.0):
    mean = rng.uniform(-spread, spread, size=(P, M, D))
    A = rng.normal(size=(P, M, D, D)) * 0.3
    cov = A @ np.swapaxes(A, -1, -2) + 0.2 * np.eye(D)
    w = rng.uniform(0.05, 1.0, size=(P, M))
    alive = np.zeros((P, M), bool)
    for p in range(P):
        alive[p, rng.choice(M, n_alive, replace=False)] = True
    return tuple(x.astype(np.float32) if x.dtype != bool else x
                 for x in (mean, cov, w, 0.5 * w, alive))


@pytest.mark.parametrize("D", [2, 3])
@pytest.mark.parametrize("case", ["match", "no_pairs", "odd_particles",
                                  "mass_conserved"])
def test_merge_matches_float64_oracle(rng, D, case):
    """The XLA merge fixpoint against the float64 greedy-pass oracle
    (rfs_slam_tpu.oracles.merge): same survivors, same moments."""
    from rfs_slam_tpu import oracles

    P, M, n_alive, spread = {
        "match": (4, 32, 20, 3.0),
        "no_pairs": (3, 16, 8, 300.0),
        "odd_particles": (5, 24, 16, 3.0),
        "mass_conserved": (3, 24, 20, 1.5),
    }[case]
    mean, cov, w, w_prev, alive = _random_dense_gm(rng, P, M, D, n_alive,
                                                   spread)
    g = GMState.from_dense(jnp.asarray(mean), jnp.asarray(cov),
                           jnp.asarray(w), jnp.asarray(w_prev),
                           jnp.asarray(alive))
    out = gm_ops.merge(g, threshold=1.5, f_inflation=1.5)
    r_mean, r_cov, r_w, r_wp, r_alive = oracles.merge(
        mean, cov, w, w_prev, alive, 1.5, 1.5)
    np.testing.assert_array_equal(np.asarray(out.alive), r_alive)
    a = r_alive
    np.testing.assert_allclose(np.asarray(out.w)[a], r_w[a], rtol=1e-5)
    np.testing.assert_allclose(np.asarray(out.w_prev)[a], r_wp[a], rtol=1e-5)
    np.testing.assert_allclose(np.asarray(out.mean_dense)[a], r_mean[a],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(out.cov_dense)[a], r_cov[a],
                               rtol=1e-3, atol=1e-5)
    if case == "no_pairs":
        assert a.sum() == alive.sum()
    else:
        assert a.sum() < alive.sum()
    if case == "mass_conserved":
        np.testing.assert_allclose(
            np.where(a, np.asarray(out.w), 0.0).sum(axis=1),
            np.where(alive, w, 0.0).sum(axis=1), rtol=1e-5)


def test_put_lane_bit_exact_vs_scatter(rng):
    """The one-hot put equals ``.at[].set`` bit for bit (full-precision
    products; values with all 24 mantissa bits in use)."""
    from rfs_slam_tpu.core import planar

    P, M, K = 6, 32, 9
    dst = jnp.asarray(rng.normal(size=(3, P, M)), jnp.float32)
    idx = jnp.asarray(np.argsort(rng.uniform(size=(P, M)), axis=1)[:, :K],
                      jnp.int32)
    src = jnp.asarray(rng.normal(size=(3, P, K)) * 1e3 + 1.0 / 3.0,
                      jnp.float32)
    valid = jnp.asarray(rng.uniform(size=(P, K)) < 0.7)
    got = jax.jit(planar.put_lane)(
        dst, jnp.broadcast_to(idx, (3, P, K)), src,
        jnp.broadcast_to(valid, (3, P, K)))
    rows = jnp.arange(P)[:, None]
    want = dst.at[:, rows, jnp.where(valid, idx, M)].set(src, mode="drop")
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_replace_weakest_bit_exact_vs_indexing(rng):
    """replace_weakest equals the plain-indexing oracle bit for bit."""
    from rfs_slam_tpu import oracles

    P, M, K, D = 5, 24, 7, 2
    w = rng.uniform(0.01, 1.0, size=(P, M)).astype(np.float32)
    g = GMState(mean=jnp.asarray(rng.normal(size=(D, P, M)), jnp.float32),
                cov=jnp.asarray(rng.uniform(0.1, 1.0, size=(3, P, M)),
                                jnp.float32),
                w=jnp.asarray(w), w_prev=jnp.asarray(w / 3.0),
                alive=jnp.asarray(rng.uniform(size=(P, M)) < 0.6))
    new = (rng.normal(size=(D, P, K)).astype(np.float32) / 3.0,
           rng.uniform(0.1, 1.0, size=(3, P, K)).astype(np.float32),
           rng.uniform(0.01, 1.0, size=(P, K)).astype(np.float32),
           rng.uniform(size=(P, K)) < 0.7)
    out = jax.jit(gm_ops.replace_weakest)(g, *map(jnp.asarray, new))
    ref = oracles.replace_weakest(
        *map(np.asarray, (g.mean, g.cov, g.w, g.w_prev, g.alive)), *new)
    for got, want in zip((out.mean, out.cov, out.w, out.w_prev, out.alive),
                         ref):
        np.testing.assert_array_equal(np.asarray(got), want)
