"""Regression-grid anchor cells, short horizon, CPU-runnable.

The regression grids (apps/batchsim.py, RESULTS.md) run at reference scale
on the accelerator; nothing else in the suite pins them, so a
hot-path "optimization" that wrecks high-clutter accuracy would pass CI and
the bench gate (which runs the easy 1e-4-clutter workload).  These anchors
run 500-step / reduced-particle versions of representative grid cells —
including the low-P_D / high-clutter corner — and fail if the tail pose
error leaves a committed band.

Bounds are ~2x the observed value at the pinned seeds (both filters are
deterministic given seeds), so they catch multiplicative regressions of the
round-3-rewrite kind, not noise.  Reference analog:
scripts/batchSim/batchSim_rbphdslam.bash:9-40.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from rfs_slam_tpu.io import sim2d


def run_cell(filt_builder, pd, clutter, steps=500, seed=0, z_capacity=32):
    sim_cfg = sim2d.Sim2DConfig(timesteps=steps, pd=pd, clutter=clutter)
    data = sim2d.generate(sim_cfg, traj_seed=seed, noise_seed=seed + 1,
                          z_capacity=z_capacity)
    filt = filt_builder(sim_cfg, z_capacity)
    state = filt.init_state(jax.random.PRNGKey(0), jnp.zeros(3))

    @jax.jit
    def step(state, inp):
        odo, z, z_mask, gt, lock = inp
        state = filt.predict(state, odo, sim_cfg.dt)
        pose = jnp.where(lock, jnp.broadcast_to(gt, state.particles.pose.shape),
                         state.particles.pose)
        state = state.replace(particles=state.particles.replace(pose=pose))
        state = filt.update(state, z, z_mask)
        best = jnp.argmax(state.particles.log_w)
        return state, state.particles.pose[best]

    T = sim_cfg.timesteps
    inputs = (
        jnp.asarray(data.odometry[1:], jnp.float32),
        jnp.asarray(data.z[1:], jnp.float32),
        jnp.asarray(data.z_mask[1:]),
        jnp.asarray(data.gt_pose[1:], jnp.float32),
        jnp.arange(1, T) <= 100,
    )
    _, best_poses = jax.lax.scan(step, state, inputs)
    best_poses = np.asarray(best_poses)
    assert np.isfinite(best_poses).all()
    err = np.linalg.norm(best_poses[:, :2] - data.gt_pose[1:, :2], axis=1)
    k0 = (3 * (T - 1)) // 4
    return float(np.mean(err[k0:]))


def build_rbphd(sim_cfg, z_capacity):
    from tests.test_rbphd_filter import build_filter

    return build_filter(sim_cfg, n_particles=48, z_capacity=z_capacity)


def build_fastslam(sim_cfg, z_capacity):
    from tests.test_fastslam import build_filter

    filt = build_filter(sim_cfg, n_particles=48)
    cfg = dataclasses.replace(filt.cfg, z_capacity=z_capacity,
                              nmz_capacity=z_capacity + 4)
    from rfs_slam_tpu.filters.fastslam import FastSLAMFilter

    return FastSLAMFilter(filt.motion, filt.lmk, filt.meas, filt.gates, cfg)


# (builder, pd, clutter, zc, name, bound_m) — bounds ~2.5x the tail error
# observed at these exact seeds/shapes when committed (round 4, CPU f32:
# rbphd_easy 0.125, rbphd_hard 0.058, rbphd_corner 0.113, fastslam_hard
# 0.011 m), so they catch multiplicative regressions, not noise
ANCHORS = [
    (build_rbphd, 0.99, 1e-4, 56, "rbphd_easy", 0.30),
    (build_rbphd, 0.75, 1e-2, 56, "rbphd_hard", 0.15),
    (build_rbphd, 0.50, 1e-1, 56, "rbphd_corner", 0.30),
    (build_fastslam, 0.50, 1e-2, 56, "fastslam_hard", 0.06),
]


@pytest.mark.parametrize("builder,pd,clutter,zc,name,bound",
                         ANCHORS, ids=[a[4] for a in ANCHORS])
def test_grid_anchor(builder, pd, clutter, zc, name, bound):
    err = run_cell(builder, pd, clutter, z_capacity=zc)
    assert err <= bound, (
        f"{name}: tail pose error {err:.3f} m exceeds anchor {bound} m "
        f"(pd={pd}, clutter={clutter}) — a hot-path change has degraded "
        f"high-clutter accuracy; see RESULTS.md grid")
