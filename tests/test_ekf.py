"""Golden tests: batched EKF correction vs a dense float64 NumPy EKF
(rfs_slam_tpu.oracles.ekf_correct)."""

import numpy as np
import jax.numpy as jnp

from rfs_slam_tpu.core import planar
from rfs_slam_tpu.models.measurement import RangeBearing
from rfs_slam_tpu.oracles import ekf_correct
from rfs_slam_tpu.ops.ekf import (InnovationGates, correct_all,
                                  correct_single, updated_mean_planes)


def pack2(S):
    return np.array([S[0, 0], S[0, 1], S[1, 1]])


def test_correct_single_matches_numpy(rng):
    model = RangeBearing(R=jnp.asarray(np.eye(2) * 0.01, jnp.float32))
    gates = InnovationGates.range_bearing()
    pose = np.array([0.1, -0.3, 0.4], np.float32)
    lm_mean = np.array([1.5, 1.2], np.float32)
    lm_cov = np.array([[0.05, 0.01], [0.01, 0.04]], np.float32)
    z = np.array([1.9, 0.8], np.float32)

    m, P, lik, md2, valid = correct_single(
        model, gates, jnp.asarray(pose), jnp.asarray(lm_mean),
        planar.pack_sym(jnp.asarray(lm_cov)), jnp.asarray(z)
    )
    m_np, P_np, lik_np, md2_np = ekf_correct(pose, lm_mean, lm_cov, z,
                                             np.eye(2) * 0.01)[:4]
    assert bool(valid)
    np.testing.assert_allclose(np.asarray(m), m_np, rtol=2e-3, atol=1e-3)
    np.testing.assert_allclose(np.asarray(P), pack2(P_np), rtol=3e-2, atol=2e-4)
    np.testing.assert_allclose(float(lik), lik_np, rtol=1e-2)
    np.testing.assert_allclose(float(md2), md2_np, rtol=1e-2, atol=1e-3)


def test_correct_all_matches_single(rng):
    P_, M_, Z_ = 3, 4, 5
    model = RangeBearing(R=jnp.asarray(np.eye(2) * 0.01, jnp.float32), r_max=100.0, r_min=0.0)
    gates = InnovationGates.range_bearing()
    poses = rng.normal(size=(P_, 3)).astype(np.float32)
    lm_mean = (rng.normal(size=(P_, M_, 2)) * 3 + 5).astype(np.float32)
    A = rng.normal(size=(P_, M_, 2, 2)).astype(np.float32) * 0.1
    lm_cov = A @ np.swapaxes(A, -1, -2) + 0.05 * np.eye(2, dtype=np.float32)
    z = rng.normal(size=(Z_, 2)).astype(np.float32)
    z[:, 0] = np.abs(z[:, 0]) + 3

    out = correct_all(
        model, gates, jnp.asarray(poses),
        planar.pack_vec(jnp.asarray(lm_mean)),
        planar.pack_sym(jnp.asarray(lm_cov)), jnp.asarray(z))
    mean_upd = updated_mean_planes(
        out, gates, planar.pack_vec(jnp.asarray(lm_mean)), jnp.asarray(z), 2)
    for p in range(P_):
        for m in range(M_):
            for k in range(Z_):
                m1, P1, lik1, md21, v1 = correct_single(
                    model, gates, jnp.asarray(poses[p]),
                    jnp.asarray(lm_mean[p, m]),
                    planar.pack_sym(jnp.asarray(lm_cov[p, m])),
                    jnp.asarray(z[k])
                )
                np.testing.assert_allclose(
                    np.asarray(mean_upd[:, p, k, m]), np.asarray(m1),
                    rtol=2e-2, atol=2e-2
                )
                np.testing.assert_allclose(
                    float(out.likelihood[p, k, m]), float(lik1), rtol=5e-2, atol=1e-5
                )
            np.testing.assert_allclose(
                np.asarray(out.cov_upd[:, p, m]),
                np.asarray(P1), rtol=5e-2, atol=1e-3
            )


def test_innovation_gates():
    gates = InnovationGates.range_bearing(range_t=0.5, bearing_t=0.1)
    z_exp = jnp.asarray([1.0, 0.0])
    # range innovation too large
    _, ok = gates.innovation(z_exp, jnp.asarray([1.6, 0.0]))
    assert not bool(ok)
    # bearing wrap brings innovation near zero: 0.05 - (-0.05 + 2pi) wraps to 0.1
    _, ok = gates.innovation(jnp.asarray([1.0, -0.04 + 2 * np.pi]), jnp.asarray([1.0, 0.04]))
    assert bool(ok)
    _, ok = gates.innovation(z_exp, jnp.asarray([1.2, 0.05]))
    assert bool(ok)
