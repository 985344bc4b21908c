"""Tests for the evaluation layer: OSPA/COLA vs a scipy oracle, the
analysis2dSim app end-to-end on synthetic logs, and the batchsim harness
entry (the reference's de-facto regression suite, SURVEY.md section 4).
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest

from rfs_slam_tpu.ops.ospa import ospa


def _ospa_oracle(x, y, c, p):
    """Dense OSPA via scipy Hungarian (OSPA.hpp:123-199 semantics)."""
    from scipy.optimize import linear_sum_assignment

    nx, ny = len(x), len(y)
    n = max(nx, ny)
    if n == 0:
        return 0.0
    C = np.full((n, n), c)
    if nx and ny:
        d = np.linalg.norm(x[:, None] - y[None, :], axis=-1)
        C[:nx, :ny] = np.minimum(d, c)
    r, cc = linear_sum_assignment(C)
    return float((np.sum(C[r, cc] ** p) / n) ** (1.0 / p))


@pytest.mark.parametrize("nx,ny,c,p", [
    (5, 5, 0.2, 1.0), (6, 3, 0.2, 1.0), (2, 7, 1.0, 2.0), (4, 4, 0.5, 2.0),
])
def test_ospa_matches_scipy_oracle(rng, nx, ny, c, p):
    x = rng.uniform(-1, 1, size=(nx, 2))
    y = rng.uniform(-1, 1, size=(ny, 2))
    n = nx + ny
    xp = np.zeros((n, 2)); xp[:nx] = x
    yp = np.zeros((n, 2)); yp[:ny] = y
    got = ospa(jnp.asarray(xp), jnp.arange(n) < nx,
               jnp.asarray(yp), jnp.arange(n) < ny, cutoff=c, order=p)
    want = _ospa_oracle(x, y, c, p)
    np.testing.assert_allclose(float(got.ospa), want, rtol=1e-4, atol=1e-5)
    # COLA rescale (COLA.hpp:91-98)
    np.testing.assert_allclose(
        float(got.cola), want * max(nx, ny) ** (1.0 / p) / c,
        rtol=1e-4, atol=1e-5)


def test_ospa_empty_sets():
    z = jnp.zeros((4, 2))
    none = jnp.zeros(4, bool)
    got = ospa(z, none, z, none, cutoff=0.2)
    assert float(got.ospa) == 0.0


def _write_fake_logs(d, T=5, P=3):
    """Minimal reference-format log dir: perfect estimate at GT + jitter."""
    rng = np.random.default_rng(0)
    t = np.arange(1, T + 1) * 0.1
    gt = np.stack([t, t, 0.5 * t, np.zeros(T)], axis=1)       # t x y th
    lmk = np.array([[1.0, 0.0, 0.1], [0.0, 1.0, 0.3]])        # x y firstObs
    os.makedirs(d, exist_ok=True)
    np.savetxt(os.path.join(d, "gtPose.dat"), gt)
    np.savetxt(os.path.join(d, "deadReckoning.dat"),
               gt[:, :4] + [0, 0.05, -0.05, 0.01])
    np.savetxt(os.path.join(d, "gtLandmark.dat"), lmk)
    with open(os.path.join(d, "particlePose.dat"), "w") as f:
        for k in range(T):
            for i in range(P):
                x = gt[k, 1] + 0.01 * i
                w = 1.0 if i == 1 else 0.2   # particle 1 is best
                f.write(f"{t[k]:.6f} {i} {x:.6f} {gt[k,2]:.6f} 0.0 {w}\n")
    with open(os.path.join(d, "landmarkEst.dat"), "w") as f:
        for k in range(T):
            for j, (lx, ly, _) in enumerate(lmk):
                jx = lx + rng.normal(scale=0.01)
                f.write(f"{t[k]:.6f} 1 {jx:.6f} {ly:.6f} "
                        f"0.01 0.0 0.01 0.9\n")
    return gt


def test_analysis2dsim_end_to_end(tmp_path):
    d = str(tmp_path / "logs")
    gt = _write_fake_logs(d)
    from rfs_slam_tpu.apps import analysis2dsim

    analysis2dsim.main([d])
    pe = np.loadtxt(os.path.join(d, "poseEstError.dat"))
    dr = np.loadtxt(os.path.join(d, "deadReckoningError.dat"))
    me = np.loadtxt(os.path.join(d, "landmarkEstError.dat"))
    # best particle (i=1) sits 0.01 from GT in x -> edist == 0.01
    np.testing.assert_allclose(pe[:, 4], 0.01, atol=1e-6)
    # dead-reckoning offset is (0.05, -0.05)
    np.testing.assert_allclose(dr[:, 4], np.hypot(0.05, 0.05), atol=1e-6)
    # both landmarks observable from t=0.3 on; estimate is tight -> low COLA
    assert me[-1, 1] == 2
    np.testing.assert_allclose(me[-1, 2], 1.8, atol=1e-6)  # sum w = 2 * 0.9
    assert me[-1, 3] < 1.0


def test_batchsim_run_one_smoke():
    """One tiny sweep cell through the real filter + sim pipeline."""
    import dataclasses

    from rfs_slam_tpu.apps.batchsim import run_one
    from rfs_slam_tpu.io.xmlconfig import XmlConfig, default_cfg, load_sim2d

    cfg = XmlConfig(default_cfg("rbphdslam2dSim.xml"))
    sim_cfg = dataclasses.replace(load_sim2d(cfg), timesteps=40,
                                  n_landmarks=8)
    mean_err, final_err, map_err, wall = run_one(
        "rbphd", cfg, sim_cfg, traj_seed=1, noise_seed=1,
        z_capacity=8, n_particles=8)
    assert np.isfinite(mean_err) and np.isfinite(final_err)
    assert np.isfinite(map_err) and map_err >= 0.0
    assert mean_err < 5.0   # coarse sanity at tiny particle count
