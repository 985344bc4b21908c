"""Oracle test: subset-sum DP vs brute-force matching enumeration.

The oracle (rfs_slam_tpu.oracles.rfs_log_likelihood) enumerates every
landmark<->measurement matching like the reference's PermutationLexicographic
path (RBPHDFilter.hpp:961-988), including the reference's zero-partition
quirk (rows with no gated measurement contribute Pd, not 1-Pd —
RBPHDFilter.hpp:905-917).
"""

import numpy as np
import jax.numpy as jnp

from rfs_slam_tpu.oracles import rfs_log_likelihood as brute_force
from rfs_slam_tpu.ops.rfs_likelihood import rfs_log_likelihood


def run_case(rng, E, Z, sparsity=0.5):
    L = rng.uniform(0.1, 5.0, size=(E, Z))
    mask = rng.uniform(size=(E, Z)) < sparsity
    L = np.where(mask, L, 0.0)
    pd = rng.uniform(0.3, 0.95, size=(E,))
    Lpd = L * pd[:, None]
    clutter = rng.uniform(0.01, 0.5, size=(Z,))
    lci = 0.7
    expect = brute_force(Lpd, pd, clutter, lci)
    got = rfs_log_likelihood(
        jnp.asarray(Lpd[None]), jnp.asarray(pd[None]),
        jnp.ones((1, E), bool), jnp.asarray(clutter[None]),
        jnp.ones((Z,), bool), lci, z_dp_max=Z,
    )
    np.testing.assert_allclose(float(got[0]), expect, rtol=1e-3, atol=3e-4)


def test_dp_matches_bruteforce_small(rng):
    for E, Z in [(1, 1), (2, 2), (3, 2), (2, 3), (4, 4), (3, 5)]:
        run_case(rng, E, Z)


def test_dp_all_rows_unsupported(rng):
    # zero table: likelihood = prod Pd_r * prod clutter_c / integral
    E, Z = 3, 2
    pd = np.array([0.9, 0.8, 0.7])
    clutter = np.array([0.1, 0.2])
    got = rfs_log_likelihood(
        jnp.zeros((1, E, Z)), jnp.asarray(pd[None]),
        jnp.ones((1, E), bool), jnp.asarray(clutter[None]),
        jnp.ones((Z,), bool), 0.0, z_dp_max=Z,
    )
    expect = np.log(pd.prod() * clutter.prod())
    np.testing.assert_allclose(float(got[0]), expect, rtol=1e-4)


def test_dp_inactive_rows_cols(rng):
    # inactive rows/columns must not affect the result
    E, Z = 3, 4
    L = rng.uniform(0.5, 2.0, size=(1, E, Z)).astype(np.float32)
    pd = np.full((1, E), 0.9, np.float32)
    clutter = np.full((1, Z), 0.1, np.float32)
    row_act = np.array([[True, True, False]])
    z_act = np.array([True, True, True, False])
    Lpd = L * 0.9
    got = rfs_log_likelihood(
        jnp.asarray(np.where(row_act[..., None], Lpd, 7.0)), jnp.asarray(pd),
        jnp.asarray(row_act), jnp.asarray(clutter), jnp.asarray(z_act), 0.0,
        z_dp_max=Z,
    )
    expect = brute_force(L[0, :2, :3] * 0.9, pd[0, :2], clutter[0, :3], 0.0)
    np.testing.assert_allclose(float(got[0]), expect, rtol=2e-4)


def test_dp_column_truncation_keeps_clutter(rng):
    # a column dropped from the DP behaves as pure clutter
    E, Z = 2, 3
    L = np.zeros((1, E, Z), np.float32)
    L[0, 0, 0] = 2.0
    L[0, 1, 1] = 1.5
    L[0, 1, 2] = 0.01  # weakest support: truncated when z_dp_max=2
    pd = np.full((1, E), 0.9, np.float32)
    clutter = np.full((1, Z), 0.1, np.float32)
    got = rfs_log_likelihood(
        jnp.asarray(L), jnp.asarray(pd), jnp.ones((1, E), bool),
        jnp.asarray(clutter), jnp.ones((Z,), bool), 0.0, z_dp_max=2,
    )
    Ltrunc = L.copy()
    Ltrunc[0, 1, 2] = 0.0
    expect = brute_force(Ltrunc[0], pd[0], clutter[0], 0.0)
    np.testing.assert_allclose(float(got[0]), expect, rtol=2e-3)


def test_dp_underflow_resistance():
    # products that underflow f32 linearly must survive via log-space scales
    E, Z = 8, 8
    L = np.zeros((1, E, Z), np.float32)
    for i in range(E):
        L[0, i, i] = 1e-6
    pd = np.full((1, E), 0.99, np.float32)
    clutter = np.full((1, Z), 1e-4, np.float32)
    got = rfs_log_likelihood(
        jnp.asarray(L), jnp.asarray(pd), jnp.ones((1, E), bool),
        jnp.asarray(clutter), jnp.ones((Z,), bool), 0.0, z_dp_max=8,
    )
    assert np.isfinite(float(got[0]))
    # dominant matching: full diagonal, value ~ (1e-6)^8, log ~ -110.5
    assert float(got[0]) > -130 and float(got[0]) < -90
