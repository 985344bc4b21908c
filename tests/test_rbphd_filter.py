"""Integration tests: RB-PHD filter on a short 2-D simulation."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from rfs_slam_tpu.filters.rbphd import RBPHDConfig, RBPHDFilter
from rfs_slam_tpu.io import sim2d
from rfs_slam_tpu.models.motion import Odometry2D, StaticLandmark
from rfs_slam_tpu.models.measurement import RangeBearing
from rfs_slam_tpu.ops.ekf import InnovationGates


def build_filter(sim_cfg: sim2d.Sim2DConfig, n_particles=24, z_capacity=24):
    dt = sim_cfg.dt
    # app wiring per rbphdslam2dSim.cpp:444-492
    Q = jnp.diag(jnp.asarray([sim_cfg.vardx, sim_cfg.vardy, sim_cfg.vardz]))
    Q = Q * (1.5 * dt * dt)  # processNoiseInflationFactor = 1.5
    motion = Odometry2D(Q=Q)
    Q_lm = jnp.diag(jnp.asarray([sim_cfg.varlmx, sim_cfg.varlmy])) * dt * dt
    lmk = StaticLandmark(Q=Q_lm)
    R = jnp.diag(jnp.asarray([sim_cfg.varzr, sim_cfg.varzb])) * 10.0  # inflation
    meas = RangeBearing(
        R=R, pd_const=sim_cfg.pd, clutter=sim_cfg.clutter,
        r_max=sim_cfg.range_max, r_min=sim_cfg.range_min,
        r_buf=sim_cfg.range_buffer,
    )
    gates = InnovationGates.range_bearing(range_t=1.0, bearing_t=0.2)
    cfg = RBPHDConfig(
        n_particles=n_particles, map_capacity=64, z_capacity=z_capacity,
        new_capacity=32, birth_capacity=8, eval_capacity=8, z_dp_max=6,
        birth_gaussian_weight=0.01, new_gaussian_md_threshold=3.0,
        eval_pt_min_weight=0.75, weighting_md_threshold=3.0,
        merge_threshold=0.5, merge_inflation=1.5, prune_threshold=0.01,
        min_updates_before_resample=2, ess_threshold=n_particles / 2,
    )
    return RBPHDFilter(motion, lmk, meas, gates, cfg)


@pytest.fixture(scope="module")
def short_sim():
    cfg = sim2d.Sim2DConfig(timesteps=260, n_landmarks=20, n_segments=4)
    return cfg, sim2d.generate(cfg, traj_seed=3, noise_seed=4, z_capacity=24)


def test_rbphd_short_run(short_sim):
    sim_cfg, data = short_sim
    filt = build_filter(sim_cfg)
    state = filt.init_state(jax.random.PRNGKey(0), jnp.zeros(3))

    @jax.jit
    def step(state, inp):
        odo, z, z_mask, gt, lock = inp
        state = filt.predict(state, odo, sim_cfg.dt)
        # groundtruth lock-in for the first 100 steps (rbphdslam2dSim.cpp:590-593)
        pose = jnp.where(lock, jnp.broadcast_to(gt, state.particles.pose.shape),
                         state.particles.pose)
        state = state.replace(particles=state.particles.replace(pose=pose))
        state = filt.update(state, z, z_mask)
        best = jnp.argmax(state.particles.log_w)
        return state, (state.particles.pose[best], state.gm.count()[best])

    T = sim_cfg.timesteps
    inputs = (
        jnp.asarray(data.odometry[1:], jnp.float32),
        jnp.asarray(data.z[1:], jnp.float32),
        jnp.asarray(data.z_mask[1:]),
        jnp.asarray(data.gt_pose[1:], jnp.float32),
        jnp.arange(1, T) <= 100,
    )
    state, (best_poses, gm_sizes) = jax.lax.scan(step, state, inputs)

    best_poses = np.asarray(best_poses)
    assert np.isfinite(best_poses).all()
    # trajectory should track groundtruth reasonably after the lock-in period
    err = np.linalg.norm(best_poses[:, :2] - data.gt_pose[1:, :2], axis=1)
    assert err[99] < 1e-4  # still locked at k=100
    assert np.median(err[150:]) < 0.6, f"median pose error {np.median(err[150:])}"
    # the map should contain landmarks
    assert int(gm_sizes[-1]) > 3
    w = np.asarray(state.gm.w)
    assert np.isfinite(w[np.asarray(state.gm.alive)]).all()


def test_rbphd_birth_from_unused(short_sim):
    sim_cfg, data = short_sim
    filt = build_filter(sim_cfg, n_particles=4)
    state = filt.init_state(jax.random.PRNGKey(0), jnp.zeros(3))

    # first update with an empty map: all measurements are unused
    k = int(np.argmax(data.z_count > 1))
    z = jnp.asarray(data.z[k], jnp.float32)
    zm = jnp.asarray(data.z_mask[k])
    state = filt.update(state, z, zm)
    assert int(state.gm.count()[0]) == 0
    np.testing.assert_array_equal(np.asarray(state.last_unused[0]), np.asarray(zm))

    # next predict creates birth Gaussians from those measurements
    state = filt.predict(state, jnp.zeros(3), sim_cfg.dt)
    assert int(state.gm.count()[0]) == int(data.z_count[k])
    w = np.asarray(state.gm.w[0])
    alive = np.asarray(state.gm.alive[0])
    np.testing.assert_allclose(w[alive], 0.01, rtol=1e-5)


def test_rbphd_empty_update_only_counts(short_sim):
    sim_cfg, data = short_sim
    filt = build_filter(sim_cfg, n_particles=4)
    state = filt.init_state(jax.random.PRNGKey(0), jnp.zeros(3))
    z = jnp.zeros((24, 2), jnp.float32)
    zm = jnp.zeros((24,), bool)
    out = filt.update(state, z, zm)
    assert int(out.n_updates) == 1
    assert int(out.n_meas) == 0
    np.testing.assert_allclose(
        np.asarray(out.particles.pose), np.asarray(state.particles.pose)
    )


def test_map_update_planes_match_float64_oracle(short_sim):
    """``_map_update`` on a mid-run map against the float64 oracle
    (rfs_slam_tpu.oracles.rbphd_map_update): Pd / FOV counts, the
    column-normalized weight table (through the cluster-process weight,
    which sums log column sums), missed-detection weights, unused
    measurements, and the new Gaussians inserted over the weakest slots."""
    import dataclasses

    from rfs_slam_tpu import oracles

    sim_cfg, data = short_sim
    filt = build_filter(sim_cfg, n_particles=8)
    filt.cfg = dataclasses.replace(filt.cfg, use_cluster_process=True)
    state = filt.init_state(jax.random.PRNGKey(0), jnp.zeros(3))

    @jax.jit
    def step(state, inp):
        odo, z, z_mask, gt = inp
        state = filt.predict(state, odo, sim_cfg.dt)
        pose = jnp.broadcast_to(gt, state.particles.pose.shape)
        state = state.replace(particles=state.particles.replace(pose=pose))
        return filt.update(state, z, z_mask), None

    t = 60
    inputs = tuple(jnp.asarray(a[1:t]) for a in
                   (data.odometry.astype(np.float32),
                    data.z.astype(np.float32), data.z_mask,
                    data.gt_pose.astype(np.float32)))
    state, _ = jax.lax.scan(step, state, inputs)
    state = filt.predict(state, jnp.asarray(data.odometry[t], jnp.float32),
                         sim_cfg.dt)
    z = jnp.asarray(data.z[t], jnp.float32)
    z_mask = jnp.asarray(data.z_mask[t])
    gm_full, log_w, unused, n_in_fov, _ = jax.jit(
        lambda s: filt._map_update(s, z, z_mask, filt.meas))(state)

    gm, m, c = state.gm, filt.meas, filt.cfg
    ref = oracles.rbphd_map_update(
        state.particles.pose, gm.mean, gm.cov, gm.w, gm.w_prev, gm.alive,
        z, z_mask, np.asarray(m.R), m.pd_const, m.clutter, m.r_max, m.r_min,
        m.r_buf, 1.0, 0.2, c.new_gaussian_md_threshold,
        c.birth_gaussian_weight, c.new_per_z, c.new_capacity)
    assert np.asarray(gm.alive).sum() > 20, "map should be populated"
    np.testing.assert_array_equal(np.asarray(n_in_fov), ref["n_in_fov"])
    np.testing.assert_array_equal(np.asarray(unused), ref["unused"])
    w_sum = np.where(np.asarray(gm.alive), np.asarray(gm.w), 0.0).sum(axis=1)
    want_lw = (np.asarray(state.particles.log_w) + w_sum
               + np.where(np.asarray(z_mask), np.log(ref["col_sum"]),
                          0.0).sum(axis=1))
    np.testing.assert_allclose(np.asarray(log_w), want_lw, rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_array_equal(np.asarray(gm_full.alive), ref["alive"])
    # new Gaussians whose weights tie in float32 (a lone cell normalizes to
    # ~1) may land in each other's victim slots: compare each particle's
    # map as a set, ordered by mean x
    for p in range(gm.w.shape[0]):
        a = ref["alive"][p]
        got_o = np.argsort(np.asarray(gm_full.mean)[0, p, a])
        ref_o = np.argsort(ref["mean"][0, p, a])
        for name, tol in (("w", 1e-7), ("w_prev", 1e-7), ("mean", 1e-5),
                          ("cov", 1e-7)):
            got = np.asarray(getattr(gm_full, name))[..., p, :][..., a]
            want = ref[name][..., p, :][..., a]
            np.testing.assert_allclose(got[..., got_o], want[..., ref_o],
                                       rtol=1e-3 if name == "cov" else 1e-4,
                                       atol=tol, err_msg=f"{name} p={p}")
