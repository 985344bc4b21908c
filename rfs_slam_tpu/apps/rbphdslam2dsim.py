"""rbphdslam2dSim — RB-PHD SLAM on the 2-D range-bearing simulation.

Equivalent of the reference executable (rbphdslam2dSim.cpp): reads a
reference-format XML config (default: the repository's
cfg/rbphdslam2dSim.xml), generates the simulation, runs the full filter as
one on-device ``lax.scan``, and writes the reference-format ``.dat`` logs so
the reference's own analysis/animation tools apply.

Usage::

    python -m rfs_slam_tpu.apps.rbphdslam2dsim [--cfg cfg/rbphdslam2dSim.xml] \
        [--trajectory N] [--seed N] [--steps N] [--logdir DIR] [--cpu]
"""

from __future__ import annotations

import argparse
import dataclasses

from rfs_slam_tpu.utils import cache

cache.enable()

import jax
import jax.numpy as jnp
import numpy as np

from rfs_slam_tpu.apps import _vp_common
from rfs_slam_tpu.filters.rbphd import RBPHDConfig, RBPHDFilter
from rfs_slam_tpu.io import logs, sim2d
from rfs_slam_tpu.io.xmlconfig import XmlConfig, default_cfg, load_sim2d
from rfs_slam_tpu.models.motion import Odometry2D, StaticLandmark
from rfs_slam_tpu.models.measurement import RangeBearing
from rfs_slam_tpu.ops.ekf import InnovationGates


def build_filter_from_xml(cfg: XmlConfig, sim_cfg: sim2d.Sim2DConfig,
                          z_capacity: int, map_capacity: int = 256,
                          n_particles: int | None = None) -> RBPHDFilter:
    """Filter wiring per rbphdslam2dSim.cpp:444-492."""
    dt = sim_cfg.dt
    n_particles = n_particles or cfg.get("filter.nParticles", 200, int)
    p_infl = cfg.get("filter.predict.processNoiseInflationFactor", 1.0)
    z_infl = cfg.get("filter.update.measurementNoiseInflationFactor", 1.0)

    motion = Odometry2D(
        Q=np.diag(np.asarray([sim_cfg.vardx, sim_cfg.vardy, sim_cfg.vardz]))
        * (p_infl * dt * dt)
    )
    lmk = StaticLandmark(
        Q=np.diag(np.asarray([sim_cfg.varlmx, sim_cfg.varlmy])) * (dt * dt)
    )
    meas = RangeBearing(
        R=np.diag(np.asarray([sim_cfg.varzr, sim_cfg.varzb])) * z_infl,
        pd_const=sim_cfg.pd, clutter=sim_cfg.clutter,
        r_max=sim_cfg.range_max, r_min=sim_cfg.range_min,
        r_buf=sim_cfg.range_buffer,
    )
    gates = InnovationGates.range_bearing(
        range_t=cfg.get("filter.update.KalmanFilter.innovationThreshold.range", -1.0),
        bearing_t=cfg.get("filter.update.KalmanFilter.innovationThreshold.bearing", -1.0),
    )
    fcfg = RBPHDConfig(
        n_particles=n_particles,
        map_capacity=map_capacity,
        z_capacity=z_capacity,
        new_capacity=64,
        birth_capacity=16,
        eval_capacity=cfg.get("filter.weighting.nEvalPt", 15, int),
        z_dp_max=10,
        birth_gaussian_weight=cfg.get("filter.predict.birthGaussianWeight", 0.01),
        new_gaussian_md_threshold=cfg.get(
            "filter.update.GaussianCreateInnovMDThreshold", 0.2),
        eval_pt_min_weight=cfg.get("filter.weighting.minWeight", 0.75),
        weighting_md_threshold=cfg.get("filter.weighting.threshold", 3.0),
        merge_threshold=cfg.get("filter.merge.threshold", 0.5),
        merge_inflation=cfg.get("filter.merge.covInflationFactor", 1.0),
        prune_threshold=cfg.get("filter.prune.threshold", 0.01),
        min_updates_before_resample=cfg.get("filter.resampling.minTimesteps", 1, int),
        ess_threshold=cfg.get("filter.resampling.effNParticle", float(n_particles)),
        use_cluster_process=cfg.get("filter.weighting.useClusterProcess", False, bool),
    )
    return RBPHDFilter(motion, lmk, meas, gates, fcfg)


def run(filt: RBPHDFilter, sim_cfg: sim2d.Sim2DConfig, data: sim2d.Sim2DData,
        gt_lock_steps: int = 100):
    """Whole-run device scan in one dispatch.

    Returns ``(state, outs, wall_s)`` with the per-step logs as host numpy
    and the wall time including compilation."""
    state = filt.init_state(jax.random.PRNGKey(0), jnp.zeros(3))
    T = sim_cfg.timesteps

    def step(state, inp):
        odo, z, z_mask, gt, lock = inp
        state = filt.predict(state, odo, sim_cfg.dt)
        pose = jnp.where(
            lock, jnp.broadcast_to(gt, state.particles.pose.shape),
            state.particles.pose,
        )
        state = state.replace(particles=state.particles.replace(pose=pose))
        state = filt.update(state, z, z_mask)
        w = jnp.exp(state.particles.log_w)
        best = jnp.argmax(w)
        gm = state.gm
        cov_packed = jnp.stack(
            [gm.cov[0, best], gm.cov[1, best], gm.cov[2, best]], axis=-1,
        )
        out = (
            state.particles.pose, w, best,
            jnp.stack([gm.mean[0, best], gm.mean[1, best]], axis=-1),
            cov_packed, gm.w[best], gm.alive[best],
        )
        return state, out

    inputs_np = [
        np.asarray(data.odometry[1:], np.float32),
        np.asarray(data.z[1:], np.float32),
        np.asarray(data.z_mask[1:]),
        np.asarray(data.gt_pose[1:], np.float32),
        np.asarray(np.arange(1, T) <= gt_lock_steps),
    ]

    @jax.jit
    def scan_all(state, inputs):
        return jax.lax.scan(step, state, inputs)

    return _vp_common.chunked_scan(scan_all, state, inputs_np,
                                   progress=False)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--cfg", default=default_cfg("rbphdslam2dSim.xml"))
    ap.add_argument("--trajectory", type=int, default=0,
                    help="trajectory random seed (reference --trajectory)")
    ap.add_argument("--seed", type=int, default=0,
                    help="noise/filter random seed (reference --seed)")
    ap.add_argument("--steps", type=int, default=None, help="override timesteps")
    ap.add_argument("--logdir", default=None)
    ap.add_argument("--particles", type=int, default=None)
    ap.add_argument("--cpu", action="store_true", help="run on CPU")
    ap.add_argument("--profile", action="store_true",
                    help="per-phase timing report (timing.dat equivalent)")
    args = ap.parse_args(argv)

    if args.cpu:
        jax.config.update("jax_default_device", jax.devices("cpu")[0])

    cfg = XmlConfig(args.cfg)
    sim_cfg = load_sim2d(cfg)
    if args.steps:
        sim_cfg = dataclasses.replace(sim_cfg, timesteps=args.steps)

    data = sim2d.generate(sim_cfg, traj_seed=args.trajectory,
                          noise_seed=args.seed, z_capacity=None)
    zc = data.z.shape[1]
    filt = build_filter_from_xml(cfg, sim_cfg, z_capacity=max(zc, 4),
                                 n_particles=args.particles)

    print(f"rbphdslam2dsim: T={sim_cfg.timesteps} P={filt.cfg.n_particles} "
          f"L={sim_cfg.n_landmarks} Zmax={zc} device={jax.devices()[0]}")
    if args.profile:
        # TimingInfo-equivalent per-phase report (RBPHDFilter.hpp:1219-1232)
        from rfs_slam_tpu.utils.timing import profile_phases
        st0 = filt.init_state(jax.random.PRNGKey(args.seed), jnp.zeros(3))
        timer = profile_phases(
            filt, st0, jnp.asarray(data.odometry[1], jnp.float32),
            sim_cfg.dt, jnp.asarray(data.z[1], jnp.float32),
            jnp.asarray(data.z_mask[1]))
        print(timer.table())

    state, outs, wall = run(filt, sim_cfg, data)
    poses, weights, best, gm_mean, gm_cov, gm_w, gm_alive = outs
    T = sim_cfg.timesteps
    err = np.linalg.norm(
        poses[np.arange(T - 1), best, :2] - data.gt_pose[1:, :2], axis=1
    )
    med_err = float(np.median(err[min(150, T // 2):]))
    print(f"done: {T - 1} steps in {wall:.2f}s "
          f"({(T - 1) / wall:.1f} timesteps/s incl. compile); median "
          f"best-particle pose err {med_err:.4f} m")

    logdir = args.logdir or cfg.get("logging.logDirPrefix", "data/rbphdslam", str)
    if cfg.get("logging.logResultsToFile", 0, int) or args.logdir:
        times = (np.arange(1, T)) * sim_cfg.dt
        logs.write_sim_data(logdir, data, dt=sim_cfg.dt, cfg_src_path=args.cfg)
        logs.write_particle_poses(logdir, times, poses, weights)
        logs.write_landmark_estimates(logdir, times, best, gm_mean, gm_cov,
                                      gm_w, gm_alive)
        if args.profile:
            logs.write_timing(logdir, timer.report())
        print(f"logs -> {logdir}")
    return _vp_common.RunSummary(steps=T - 1, wall_s=wall,
                                 median_pose_err_m=med_err,
                                 finite=_vp_common.all_finite(outs))


if __name__ == "__main__":
    main()
