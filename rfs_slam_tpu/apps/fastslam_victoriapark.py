"""fastslam_VictoriaPark — FastSLAM / MH-FastSLAM on the Victoria Park dataset.

Equivalent of the reference executable
(fastslam_VictoriaPark.cpp:61-874): FastSLAM<Ackerman2d, StaticProcessModel
<Landmark3d>, MeasurementModel_VictoriaPark, KalmanFilter_VictoriaPark>
(fastslam_VictoriaPark.cpp:67-70).  Reads the reference XML config UNCHANGED
(including cfg/mhfastslam_VictoriaPark.xml, which selects MH-FastSLAM purely
via maxNDataAssocHypotheses > 1 — there is no separate MH source file,
README.md:99-102), buckets the sensor-manager event stream into fixed-shape
lidar frames, runs the filter as a device scan, and writes reference-format
logs.

Usage::

    python -m rfs_slam_tpu.apps.fastslam_victoriapark \
        --data <VictoriaPark dataset dir> [--cfg XML] [--messages N] \
        [--logdir DIR]

The default config is the repository's cfg/fastslam_VictoriaPark.xml.
"""

from __future__ import annotations

import argparse
import time

from rfs_slam_tpu.utils import cache

cache.enable()

import jax
import jax.numpy as jnp
import numpy as np

from rfs_slam_tpu.filters.fastslam import FastSLAMConfig, FastSLAMFilter
from rfs_slam_tpu.apps import _vp_common
from rfs_slam_tpu.io import logs
from rfs_slam_tpu.io import victoria_park as vp_io
from rfs_slam_tpu.io.xmlconfig import XmlConfig, default_cfg
from rfs_slam_tpu.models.motion import Ackerman2D, StaticLandmark
from rfs_slam_tpu.models.victoria_park import VictoriaPark, fov_area_clutter
from rfs_slam_tpu.ops.ekf import InnovationGates
from rfs_slam_tpu.apps.rbphdslam_victoriapark import gps_rmse


def build(cfg: XmlConfig, z_capacity: int, map_capacity: int,
          n_particles: int | None, hypotheses: int | None = None,
          window: float | None = None,
          murty_lane_budget: int | str | None = "auto"):
    """Wiring per fastslam_VictoriaPark.cpp:85-184, 360-400.

    ``hypotheses``/``window`` override the XML's maxNDataAssocHypotheses /
    maxDataAssocLogLikelihoodDiff (counterfactual divergence probes).
    ``murty_lane_budget="auto"`` = n_particles (P_cap/3 under the default
    grow cap) — see apps/fastslam2dsim.py for the sizing A/B; ``None``
    disables lane gating (every lane runs the full Murty expansion)."""
    n_particles = n_particles or cfg.get("filter.nParticles", 200, int)
    if murty_lane_budget == "auto":
        murty_lane_budget = n_particles
    z_infl = cfg.get("filter.update.measurementNoiseInflationFactor", 1.0)
    ack = (
        cfg.get("process.AckermanModel.rearWheelOffset", 0.76),
        cfg.get("process.AckermanModel.frontToRearDist", 2.83),
        cfg.get("process.AckermanModel.sensorOffset_x", 3.78),
        cfg.get("process.AckermanModel.sensorOffset_y", 0.5),
    )
    motion = Ackerman2D(Q=np.zeros((3, 3), np.float32), h=ack[0], l=ack[1],
                        dx=ack[2], dy=ack[3])
    input_cov = np.diag(np.asarray([
        cfg.get("process.varuv", 0.2), cfg.get("process.varur", 0.025)]))
    lmk = StaticLandmark(
        Q=np.diag(np.asarray([
            cfg.get("landmarks.varlmx", 5e-4),
            cfg.get("landmarks.varlmy", 5e-4),
            cfg.get("landmarks.varlmd", 1e-4)])),
        per_dt2=True,
    )
    R = np.diag(np.asarray([
        cfg.get("measurements.varzr", 0.025),
        cfg.get("measurements.varzb", 2.5e-5),
        cfg.get("measurements.varzd", 2e-3)])) * z_infl
    b_min = cfg.get("measurements.bearingLimitMin", 6.3) * np.pi / 180
    b_max = cfg.get("measurements.bearingLimitMax", 177.0) * np.pi / 180
    r_min = cfg.get("measurements.rangeLimitMin", 5.0)
    r_max = cfg.get("measurements.rangeLimitMax", 70.0)
    expected_clutter = cfg.get("measurements.expectedNClutter", 3.0)
    meas = VictoriaPark(
        R=R,
        slb=np.asarray(cfg.get("measurements.varza", 1e-5)),
        pd_table=np.asarray(cfg.get_list("measurements.Pd", "value")),
        r_max=r_max, r_min=r_min, b_max=b_max, b_min=b_min,
        buffer_pd=cfg.get("measurements.bufferZonePd", 0.4),
        expected_clutter=expected_clutter,
        clutter_value=fov_area_clutter(expected_clutter, r_min, r_max,
                                       b_min, b_max),
    )
    gates = InnovationGates(
        thresholds=np.asarray([
            cfg.get("filter.update.KalmanFilter.innovationThreshold.range", -1.0),
            cfg.get("filter.update.KalmanFilter.innovationThreshold.bearing", -1.0),
            -1.0,
        ]),
        wrap_dims=(1,),
    )
    fcfg = FastSLAMConfig(
        n_particles=n_particles,
        map_capacity=map_capacity,
        z_capacity=z_capacity,
        nmz_capacity=max(z_capacity, 32),
        candidate_capacity=24,
        max_hypotheses=(hypotheses if hypotheses is not None else
                        cfg.get("filter.update.maxNDataAssocHypotheses",
                                1, int)),
        murty_lane_budget=murty_lane_budget,
        max_da_loglik_diff=(window if window is not None else cfg.get(
            "filter.update.maxDataAssocLogLikelihoodDiff", 3.0)),
        min_log_likelihood=cfg.get(
            "filter.weighting.minLogMeasurementLikelihood", -10.0),
        lock_weight=cfg.get("filter.update.landmarkLockWeight", 10.0),
        prune_threshold=cfg.get("filter.prune.threshold", -5.0),
        prune_z_threshold=cfg.get("filter.prune.nMeasurementsThreshold", 0, int),
        cand_support_dist=cfg.get(
            "filter.update.landmarkCandidate.MeasurementSupportDist", 1.0),
        cand_count_threshold=cfg.get(
            "filter.update.landmarkCandidate.MeasurementCountThreshold", 1, int),
        cand_check_threshold=cfg.get(
            "filter.update.landmarkCandidate.MeasurementCheckThreshold", 2, int),
        cand_current_meas_count_threshold=cfg.get(
            "filter.update.landmarkCandidate.CurrentMeasurementCountThreshold",
            1, int),
        min_updates_before_resample=cfg.get(
            "filter.resampling.minTimesteps", 1, int),
        min_measurements_before_resample=cfg.get(
            "filter.resampling.minMeasurements", 0, int),
        ess_threshold=cfg.get("filter.resampling.effNParticle",
                              float(n_particles)),
    )
    return FastSLAMFilter(motion, lmk, meas, gates, fcfg), input_cov, ack


def run(filt: FastSLAMFilter, input_cov, frames: vp_io.VPFrames,
        artificial_clutter: float = 0.0, seed: int = 0,
        ckpt_dir: str | None = None, ckpt_every: int = 0,
        resume: bool = False, resume_at: int | None = None,
        ckpt_keep: int = 3, reseed: int | None = None):
    """Chunked device scan over frames; see rbphdslam_victoriapark.run."""
    F, K = frames.pred_dt.shape

    z = frames.z.copy()
    z_mask = frames.z_mask.copy()
    if artificial_clutter > 0:
        rng = np.random.default_rng(seed)
        mm = filt.meas
        for j in range(F):
            n_c = rng.poisson(artificial_clutter)
            free = np.nonzero(~z_mask[j])[0]
            for i in range(min(n_c, len(free))):
                r = rng.uniform(float(mm.r_min), float(mm.r_max))
                b = rng.uniform(float(mm.b_min), float(mm.b_max))
                z[j, free[i]] = [r, b, 1.0]
                z_mask[j, free[i]] = True

    state = filt.init_state(jax.random.PRNGKey(seed), jnp.zeros(3), d=3)
    has_scan = frames.scans is not None

    def frame_step(state, inp):
        if has_scan:
            pdt, pu, pnoise, zf, zmf, scan = inp
            meas = filt.meas.with_scan(scan)
        else:
            pdt, pu, pnoise, zf, zmf = inp
            meas = filt.meas

        def substep(s, sub):
            dt, u, noise = sub
            return filt.predict(s, u, dt, use_model_noise=False,
                                use_input_noise=noise, input_cov=input_cov), None

        state, _ = jax.lax.scan(substep, state, (pdt, pu, pnoise))
        state = filt.update(state, zf, zmf, meas=meas)

        w = jnp.exp(state.particles.log_w - jax.scipy.special.logsumexp(
            state.particles.log_w))
        best = jnp.argmax(w)
        gm = state.gm
        cov_packed = jnp.stack(
            [gm.cov[0, best], gm.cov[1, best], gm.cov[3, best]], axis=-1)
        # log-odds -> probability for the landmark weight column
        p_exist = jax.nn.sigmoid(gm.w[best])
        out = (state.particles.pose, w, best,
               jnp.stack([gm.mean[0, best], gm.mean[1, best]], axis=-1),
               cov_packed, p_exist, gm.alive[best],
               state.particles.parent)
        return state, out

    inputs_np = [
        np.asarray(frames.pred_dt, np.float32),
        np.asarray(frames.pred_u, np.float32),
        np.asarray(frames.pred_noise),
        np.asarray(z, np.float32),
        np.asarray(z_mask),
    ]
    if has_scan:
        inputs_np.append(np.asarray(frames.scans, np.float32))

    @jax.jit
    def scan_all(state, inputs):
        return jax.lax.scan(frame_step, state, tuple(inputs))

    return _vp_common.chunked_scan(
        scan_all, state, inputs_np, ckpt_dir=ckpt_dir,
        ckpt_every=ckpt_every, resume=resume, resume_at=resume_at,
        ckpt_keep=ckpt_keep, reseed=reseed)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--cfg", default=default_cfg("fastslam_VictoriaPark.xml"))
    ap.add_argument("--data", required=True,
                    help="Victoria Park dataset directory (reference format)")
    ap.add_argument("--messages", type=int, default=None,
                    help="process only the first N sensor messages")
    ap.add_argument("--logdir", default=None)
    ap.add_argument("--particles", type=int, default=None)
    ap.add_argument("--map-capacity", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--hypotheses", type=int, default=None,
                    help="override XML maxNDataAssocHypotheses")
    ap.add_argument("--window", type=float, default=None,
                    help="override XML maxDataAssocLogLikelihoodDiff")
    ap.add_argument("--murty-lane-budget", type=int, default=-1,
                    help="max particle lanes running the full Murty "
                         "expansion per update (-1 = auto [n_particles], "
                         "0 = all lanes)")
    _vp_common.add_ckpt_args(ap)
    args = ap.parse_args(argv)

    cfg = XmlConfig(args.cfg)
    n_msgs = args.messages if args.messages is not None else cfg.get(
        "filter.nMsgToProcess", 0, int)
    filt, input_cov, ack = build(cfg, z_capacity=24,
                                 map_capacity=args.map_capacity,
                                 n_particles=args.particles,
                                 hypotheses=args.hypotheses,
                                 window=args.window,
                                 murty_lane_budget=(
                                     "auto" if args.murty_lane_budget < 0
                                     else args.murty_lane_budget or None))
    frames = vp_io.load(args.data, scale_ur=cfg.get("process.ur_scale", 1.0),
                        z_capacity=24, n_messages=n_msgs, ackerman=ack)
    F = len(frames.t)
    mh = filt.cfg.max_hypotheses
    print(f"fastslam victoriapark: {F} lidar frames, "
          f"P={filt.cfg.n_particles}, hypotheses={mh}"
          f"{' (MH-FastSLAM)' if mh > 1 else ''}, "
          f"device={jax.devices()[0]}")

    clutter_added = cfg.get("measurements.addedClutter", 0.0)
    if args.ckpt_dir:
        import os as _os
        _os.makedirs(args.ckpt_dir, exist_ok=True)
    state, outs, wall = run(filt, input_cov, frames,
                            artificial_clutter=clutter_added, seed=args.seed,
                            ckpt_dir=args.ckpt_dir,
                            ckpt_every=args.ckpt_every, resume=args.resume,
                            resume_at=args.resume_at,
                            ckpt_keep=args.ckpt_keep, reseed=args.reseed)
    poses, weights, best, gm_mean, gm_cov, gm_w, gm_alive, parents = outs
    print(f"done: {F} frames in {wall:.1f}s ({F / wall:.1f} frames/s incl. compile)")

    # final best particle's consistent history via the resampling ancestry
    # (rbphdslam_VictoriaPark.cpp:631-660)
    best_poses = logs.ancestral_path(poses, parents, best[-1])
    rmse = gps_rmse(frames.t, best_poses, frames.gps)
    dr_rmse = gps_rmse(frames.t, frames.dr_pose, frames.gps)
    print(f"trajectory RMSE vs GPS: {rmse:.2f} m  (dead reckoning: {dr_rmse:.2f} m)")

    logdir = args.logdir or cfg.get("logging.logDirPrefix",
                                    "data/VictoriaPark/fastslam/results/", str)
    if cfg.get("logging.logResultsToFile", 0, int) or args.logdir:
        logs.write_particle_poses(logdir, frames.t, poses, weights)
        logs.write_landmark_estimates(logdir, frames.t, best, gm_mean, gm_cov,
                                      gm_w, gm_alive)
        logs.write_trajectory(logdir, frames.t, best_poses)
        print(f"logs -> {logdir}")


if __name__ == "__main__":
    main()
