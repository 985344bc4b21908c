"""JCBB beam search vs an exhaustive interpretation-tree oracle.

The oracle enumerates every injective partial assignment (measurement ->
landmark or none), applies the same per-level joint chi-square gate as the
reference's branch & bound (JCBB.hpp:344-520), and picks max pairings with
minimal joint Mahalanobis distance as tie-break.  With a beam wider than the
interpretation tree the batched op must match it exactly.
"""

import itertools

import numpy as np
import jax.numpy as jnp
import pytest

from rfs_slam_tpu.ops.jcbb import chi2_quantile, jcbb, jcbb_block_diag


def build_problem(rng, Z, M, D=2, correlated=True):
    """Innovations + consistent joint covariance.

    nu[z, m] shares pose uncertainty across all pairs:
    cov(nu[z1,m1], nu[z2,m2]) = P_pose + d(m1,m2) P_m + d(z1,z2) R.
    """
    P_pose = np.eye(D) * 0.3 if correlated else np.zeros((D, D))
    P_m = np.stack([np.eye(D) * (0.2 + 0.1 * i) for i in range(M)])
    R = np.eye(D) * 0.1
    S = np.zeros((Z, M, Z, M, D, D))
    for z1, m1, z2, m2 in itertools.product(range(Z), range(M), range(Z), range(M)):
        c = P_pose.copy()
        if m1 == m2:
            c += P_m[m1]
        if z1 == z2:
            c += R
        S[z1, m1, z2, m2] = c
    innov = rng.normal(size=(Z, M, D)) * 0.7
    return innov, S


def oracle(innov, S, confidence=0.95):
    Z, M, D = innov.shape
    best = (-1, np.inf, None)  # (npairs, md2, assoc)
    for assoc in itertools.product(range(-1, M), repeat=Z):
        used = [m for m in assoc if m >= 0]
        if len(set(used)) != len(used):
            continue
        # per-level joint compatibility along z order
        ok = True
        md2 = 0.0
        for prefix in range(1, Z + 1):
            pairs = [(z, assoc[z]) for z in range(prefix) if assoc[z] >= 0]
            if not pairs:
                continue
            nu = np.concatenate([innov[z, m] for z, m in pairs])
            Sj = np.block([[S[z1, m1, z2, m2] for (z2, m2) in pairs]
                           for (z1, m1) in pairs])
            md2 = nu @ np.linalg.solve(Sj, nu)
            if md2 > float(chi2_quantile(confidence, len(pairs) * D)):
                ok = False
                break
        if not ok:
            continue
        npairs = len(used)
        if (npairs > best[0]) or (npairs == best[0] and md2 < best[1] - 1e-9):
            best = (npairs, md2, assoc)
    return best


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("correlated", [False, True])
def test_jcbb_matches_oracle(seed, correlated):
    rng = np.random.default_rng(seed)
    Z, M, D = 3, 4, 2
    innov, S = build_problem(rng, Z, M, D, correlated)
    n_ref, md2_ref, assoc_ref = oracle(innov, S)

    assoc, npair, md2 = jcbb(
        jnp.asarray(innov, jnp.float32), jnp.asarray(S, jnp.float32),
        jnp.ones((Z,), bool), jnp.ones((M,), bool),
        confidence=0.95, beam=160)
    assert int(npair) == n_ref
    np.testing.assert_allclose(float(md2), md2_ref, rtol=2e-3, atol=1e-4)
    # max-cardinality solution may tie; association must match when unique
    if assoc_ref is not None:
        np.testing.assert_array_equal(np.asarray(assoc), assoc_ref)


def test_jcbb_block_diag_gates():
    # two obvious matches, one clutter measurement far away
    Z, M, D = 3, 2, 2
    innov = np.full((Z, M, D), 50.0)
    innov[0, 0] = [0.05, 0.0]
    innov[1, 1] = [0.0, 0.05]
    S_diag = np.stack([np.eye(D) * 0.1] * M)
    assoc, npair, md2 = jcbb_block_diag(
        jnp.asarray(innov, jnp.float32), jnp.asarray(S_diag, jnp.float32),
        jnp.ones((Z,), bool), jnp.ones((M,), bool), beam=32)
    assert int(npair) == 2
    np.testing.assert_array_equal(np.asarray(assoc), [0, 1, -1])


def test_chi2_quantile_sanity():
    # Wilson-Hilferty vs known chi2 quantiles (df=2: q95=5.991, df=6: 12.592)
    assert abs(float(chi2_quantile(0.95, 2)) - 5.991) < 0.15
    assert abs(float(chi2_quantile(0.95, 6)) - 12.592) < 0.15
    assert abs(float(chi2_quantile(0.99, 4)) - 13.277) < 0.2
