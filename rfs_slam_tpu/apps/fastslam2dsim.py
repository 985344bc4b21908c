"""fastslam2dSim — FastSLAM 1.0 / MH-FastSLAM on the 2-D sim.

Equivalent of the reference executable (fastslam2dSim.cpp); MH-FastSLAM
is selected by ``<maxNDataAssocHypotheses>`` in the XML, exactly as in the
reference (cfg/mhfastslam2dSim.xml differs from cfg/fastslam2dSim.xml only
in that key).  The default config is the repository's cfg/fastslam2dSim.xml.

Usage::

    python -m rfs_slam_tpu.apps.fastslam2dsim [--cfg cfg/fastslam2dSim.xml] \
        [--trajectory N] [--seed N] [--steps N] [--logdir DIR]
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
from rfs_slam_tpu.filters.fastslam import FastSLAMConfig, FastSLAMFilter
from rfs_slam_tpu.io import logs, sim2d
from rfs_slam_tpu.io.xmlconfig import XmlConfig, default_cfg, load_sim2d
from rfs_slam_tpu.models.motion import Odometry2D, StaticLandmark
from rfs_slam_tpu.models.measurement import RangeBearing
from rfs_slam_tpu.ops.ekf import InnovationGates


def build_filter_from_xml(cfg: XmlConfig, sim_cfg: sim2d.Sim2DConfig,
                          z_capacity: int, n_particles: int | None = None,
                          murty_child_cap: int | None = 6,
                          murty_lane_budget: int | str | None = "auto"):
    """Wiring per fastslam2dSim.cpp:452-482.

    ``murty_lane_budget="auto"`` resolves to ``n_particles`` (= P_cap/3
    under the default grow cap) — the measured p90 of the per-step
    ambiguous-lane count on the 2-D sim (scripts/mh_ambiguity_probe.py),
    A/B'd at T=1500 seed 0: 637.9 -> 225.8 s at median pose error
    0.0209 -> 0.0137 m (inside the documented ±0.03 run-noise band).
    ``None`` disables gating (every lane runs the full expansion)."""
    dt = sim_cfg.dt
    n_particles = n_particles or cfg.get("filter.nParticles", 200, int)
    if murty_lane_budget == "auto":
        murty_lane_budget = n_particles
    p_infl = cfg.get("filter.predict.processNoiseInflationFactor", 1.0)
    z_infl = cfg.get("filter.update.measurementNoiseInflationFactor", 1.0)

    motion = Odometry2D(
        Q=np.diag(np.asarray([sim_cfg.vardx, sim_cfg.vardy, sim_cfg.vardz]))
        * (p_infl * dt * dt))
    lmk = StaticLandmark(
        Q=np.diag(np.asarray([sim_cfg.varlmx, sim_cfg.varlmy])) * (dt * dt))
    meas = RangeBearing(
        R=np.diag(np.asarray([sim_cfg.varzr, sim_cfg.varzb])) * z_infl,
        pd_const=sim_cfg.pd, clutter=sim_cfg.clutter,
        r_max=sim_cfg.range_max, r_min=sim_cfg.range_min,
        r_buf=sim_cfg.range_buffer)
    gates = InnovationGates.range_bearing(
        range_t=cfg.get("filter.update.KalmanFilter.innovationThreshold.range", -1.0),
        bearing_t=cfg.get("filter.update.KalmanFilter.innovationThreshold.bearing", -1.0))
    fcfg = FastSLAMConfig(
        n_particles=n_particles,
        map_capacity=128,
        z_capacity=z_capacity,
        nmz_capacity=max(z_capacity + 4, 32),
        candidate_capacity=16,
        max_hypotheses=cfg.get("filter.update.maxNDataAssocHypotheses", 1, int),
        murty_child_cap=murty_child_cap,
        murty_lane_budget=murty_lane_budget,
        max_da_loglik_diff=cfg.get("filter.update.maxDataAssocLogLikelihoodDiff", 3.0),
        min_log_likelihood=cfg.get("filter.weighting.minLogMeasurementLikelihood", -10.0),
        existence_prior=0.5,
        prune_threshold=cfg.get("filter.prune.threshold", -5.0),
        min_updates_before_resample=cfg.get("filter.resampling.minTimesteps", 1, int),
        ess_threshold=cfg.get("filter.resampling.effNParticle", float(n_particles)),
    )
    return FastSLAMFilter(motion, lmk, meas, gates, fcfg)


def run(filt, sim_cfg, data, gt_lock_steps: int = 100):
    """Whole-run device scan in one dispatch.

    Returns ``(state, outs, wall_s)`` with the per-step logs as host numpy
    and the wall time including compilation."""
    state = filt.init_state(jax.random.PRNGKey(0), jnp.zeros(3))
    T = sim_cfg.timesteps

    def step(state, inp):
        odo, z, z_mask, gt, lock = inp
        state = filt.predict(state, odo, sim_cfg.dt)
        pose = jnp.where(lock, jnp.broadcast_to(gt, state.particles.pose.shape),
                         state.particles.pose)
        state = state.replace(particles=state.particles.replace(pose=pose))
        state = filt.update(state, z, z_mask)
        w = jnp.exp(state.particles.log_w)
        best = jnp.argmax(w)
        gm = state.gm
        cov_packed = jnp.stack(
            [gm.cov[0, best], gm.cov[1, best], gm.cov[2, best]], axis=-1)
        return state, (state.particles.pose, w, best,
                       jnp.stack([gm.mean[0, best], gm.mean[1, best]], axis=-1),
                       cov_packed, gm.w[best], gm.alive[best])

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
    ap.add_argument("--cfg", default=default_cfg("fastslam2dSim.xml"))
    ap.add_argument("--trajectory", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--logdir", default=None)
    ap.add_argument("--particles", type=int, default=None)
    ap.add_argument("--murty-cap", type=int, default=6,
                    help="murty child_cap (0 = uncapped exact solver)")
    ap.add_argument("--murty-lane-budget", type=int, default=-1,
                    help="max particle lanes running the full Murty "
                         "expansion per update (-1 = auto [n_particles], "
                         "0 = all lanes; see "
                         "FastSLAMConfig.murty_lane_budget)")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    if args.cpu:
        jax.config.update("jax_default_device", jax.devices("cpu")[0])

    cfg = XmlConfig(args.cfg)
    sim_cfg = load_sim2d(cfg)
    if args.steps:
        sim_cfg = dataclasses.replace(sim_cfg, timesteps=args.steps)
    data = sim2d.generate(sim_cfg, traj_seed=args.trajectory,
                          noise_seed=args.seed)
    zc = data.z.shape[1]
    lane_budget = ("auto" if args.murty_lane_budget < 0
                   else args.murty_lane_budget or None)
    filt = build_filter_from_xml(cfg, sim_cfg, z_capacity=max(zc, 4),
                                 n_particles=args.particles,
                                 murty_child_cap=args.murty_cap or None,
                                 murty_lane_budget=lane_budget)
    print(f"fastslam2dsim: T={sim_cfg.timesteps} P={filt.cfg.n_particles} "
          f"H={filt.cfg.max_hypotheses} Zmax={zc} device={jax.devices()[0]}")
    state, outs, wall = run(filt, sim_cfg, data)
    poses, weights, best, gm_mean, gm_cov, gm_w, gm_alive = outs
    T = sim_cfg.timesteps
    err = np.linalg.norm(
        poses[np.arange(T - 1), best, :2] - data.gt_pose[1:, :2], axis=1)
    med_err = float(np.median(err[min(150, T // 2):]))
    print(f"done: {T - 1} steps in {wall:.2f}s "
          f"({(T - 1) / wall:.1f} timesteps/s incl. compile); median "
          f"best-particle pose err {med_err:.4f} m")

    logdir = args.logdir or cfg.get("logging.logDirPrefix", "data/fastslam", str)
    if cfg.get("logging.logResultsToFile", 0, int) or args.logdir:
        times = np.arange(1, T) * sim_cfg.dt
        logs.write_sim_data(logdir, data, dt=sim_cfg.dt, cfg_src_path=args.cfg)
        logs.write_particle_poses(logdir, times, poses, weights)
        logs.write_landmark_estimates(logdir, times, best, gm_mean, gm_cov,
                                      gm_w, gm_alive)
        print(f"logs -> {logdir}")
    return _vp_common.RunSummary(steps=T - 1, wall_s=wall,
                                 median_pose_err_m=med_err,
                                 finite=_vp_common.all_finite(outs))


if __name__ == "__main__":
    main()
