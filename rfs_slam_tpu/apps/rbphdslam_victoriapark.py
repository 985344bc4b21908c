"""rbphdslam_VictoriaPark — RB-PHD SLAM on the Victoria Park dataset.

Equivalent of the reference executable (rbphdslam_VictoriaPark.cpp): reads
a reference-format XML config (default: the repository's
cfg/rbphdslam_VictoriaPark.xml), buckets the sensor-manager event stream into fixed-shape lidar frames
(io/victoria_park.py), runs the full filter as a device scan over frames
(with an inner scan over the frame's predict sub-steps), and writes
reference-format logs (particlePose.dat, landmarkEst.dat, trajectory.dat).

Usage::

    python -m rfs_slam_tpu.apps.rbphdslam_victoriapark \
        --data <VictoriaPark dataset dir> [--cfg XML] [--messages N] \
        [--logdir DIR]
"""

from __future__ import annotations

import argparse
import os
import time

from rfs_slam_tpu.utils import cache

cache.enable()

import jax
import jax.numpy as jnp
import numpy as np

from rfs_slam_tpu.filters.rbphd import RBPHDConfig, RBPHDFilter
from rfs_slam_tpu.apps import _vp_common
from rfs_slam_tpu.io import logs
from rfs_slam_tpu.io import victoria_park as vp_io
from rfs_slam_tpu.io.xmlconfig import XmlConfig, default_cfg
from rfs_slam_tpu.models.motion import Ackerman2D, StaticLandmark
from rfs_slam_tpu.models.victoria_park import VictoriaPark, fov_area_clutter
from rfs_slam_tpu.ops.ekf import InnovationGates


def build(cfg: XmlConfig, z_capacity: int, map_capacity: int,
          n_particles: int | None, z_dp_max: int = 8):
    """Wiring per rbphdslam_VictoriaPark.cpp:360-400."""
    n_particles = n_particles or cfg.get("filter.nParticles", 100, int)
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
    fcfg = RBPHDConfig(
        n_particles=n_particles,
        map_capacity=map_capacity,
        z_capacity=z_capacity,
        new_capacity=48,
        birth_capacity=24,
        eval_capacity=cfg.get("filter.weighting.nEvalPt", 15, int),
        z_dp_max=z_dp_max,
        birth_gaussian_weight=cfg.get("filter.predict.birthGaussian.Weight", 0.01),
        birth_count_threshold=cfg.get(
            "filter.predict.birthGaussian.SupportMeasurementThreshold", 5, int),
        birth_check_threshold=cfg.get(
            "filter.predict.birthGaussian.CheckCountThreshold", 10, int),
        birth_support_dist=cfg.get(
            "filter.predict.birthGaussian.SupportMeasurementDist", 2.0),
        birth_current_meas_count_threshold=cfg.get(
            "filter.predict.birthGaussian.CurrentMeasurementCountThreshold", 2, int),
        new_gaussian_md_threshold=cfg.get(
            "filter.update.GaussianCreateInnovMDThreshold", 3.0),
        eval_pt_min_weight=cfg.get("filter.weighting.minWeight", 0.75),
        weighting_md_threshold=cfg.get("filter.weighting.threshold", 3.0),
        merge_threshold=cfg.get("filter.merge.threshold", 0.5),
        merge_inflation=cfg.get("filter.merge.covInflationFactor", 1.0),
        prune_threshold=cfg.get("filter.prune.threshold", 0.01),
        min_updates_before_resample=cfg.get("filter.resampling.minTimesteps", 1, int),
        min_measurements_before_resample=cfg.get(
            "filter.resampling.minMeasurements", 0, int),
        ess_threshold=cfg.get("filter.resampling.effNParticle", float(n_particles)),
        use_cluster_process=cfg.get("filter.weighting.useClusterProcess", False, bool),
    )
    return RBPHDFilter(motion, lmk, meas, gates, fcfg), input_cov, ack


def run(filt: RBPHDFilter, input_cov, frames: vp_io.VPFrames,
        artificial_clutter: float = 0.0, seed: int = 0,
        ckpt_dir: str | None = None, ckpt_every: int = 0,
        resume: bool = False):
    """Run the filter over the frame stream as chunked device scans.

    ``ckpt_every`` > 0 splits the run into chunks of that many lidar frames;
    after each chunk the filter state is snapshotted (utils/checkpoint.py)
    and the chunk's per-frame outputs are persisted, so ``resume=True``
    continues an interrupted run bit-identically (chunking does not change
    the math: the RNG key lives in the state).  The reference has no
    checkpointing (SURVEY.md section 5) — a 69.9k-message run restarts from
    scratch there.
    """
    cfg = filt.cfg
    F, K = frames.pred_dt.shape

    # optional artificial clutter injection (rbphdslam_VictoriaPark.cpp:555-580)
    z = frames.z.copy()
    z_mask = frames.z_mask.copy()
    if artificial_clutter > 0:
        rng = np.random.default_rng(seed)
        meas_model = filt.meas
        for j in range(F):
            n_c = rng.poisson(artificial_clutter)
            free = np.nonzero(~z_mask[j])[0]
            for i in range(min(n_c, len(free))):
                r = rng.uniform(float(meas_model.r_min), float(meas_model.r_max))
                b = rng.uniform(float(meas_model.b_min), float(meas_model.b_max))
                z[j, free[i]] = [r, b, 1.0]
                z_mask[j, free[i]] = True

    state = filt.init_state(jax.random.PRNGKey(seed), jnp.zeros(3), dz=3, d=3)
    has_scan = frames.scans is not None

    def frame_step(state, inp):
        if has_scan:
            pdt, pu, pnoise, zf, zmf, scan = inp
            meas = filt.meas.with_scan(scan)
        else:
            pdt, pu, pnoise, zf, zmf = inp
            meas = filt.meas

        # births once per frame (birthGaussianCheck semantics: the first
        # predict after an update checks births — :512-517)
        key = state.particles.key
        gm, birth = filt._add_birth_gaussians(state, key, meas)
        state = state.replace(gm=gm, birth=birth)

        def substep(s, sub):
            dt, u, noise = sub
            # dt == 0 padding: motion step and cov growth are no-ops
            return filt.predict(s, u, dt, use_model_noise=False,
                                use_input_noise=noise, input_cov=input_cov,
                                birth_check=False, meas=meas), None

        state, _ = jax.lax.scan(substep, state, (pdt, pu, pnoise))
        state = filt.update(state, zf, zmf, meas=meas)

        w = jnp.exp(state.particles.log_w)
        best = jnp.argmax(w)
        gm = state.gm
        cov_packed = jnp.stack(
            [gm.cov[0, best], gm.cov[1, best], gm.cov[3, best]], axis=-1)
        out = (state.particles.pose, w, best,
               jnp.stack([gm.mean[0, best], gm.mean[1, best]], axis=-1),
               cov_packed, gm.w[best], gm.alive[best],
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
        ckpt_every=ckpt_every, resume=resume)


def gps_rmse(times, best_poses, gps):
    """Trajectory error vs GPS fixes (position only).

    Each GPS fix is matched to the NEAREST estimate time on either side
    (searchsorted alone returns the next frame at-or-after, which scored the
    trajectory asymmetrically) and scored when within the 0.5 s window.
    """
    right = np.clip(np.searchsorted(times, gps[:, 0]), 0, len(times) - 1)
    left = np.clip(right - 1, 0, len(times) - 1)
    d_right = np.abs(times[right] - gps[:, 0])
    d_left = np.abs(times[left] - gps[:, 0])
    idx = np.where(d_left < d_right, left, right)
    ok = np.abs(times[idx] - gps[:, 0]) < 0.5
    if ok.sum() == 0:
        return float("nan")
    d = best_poses[idx[ok], :2] - gps[ok, 1:3]
    return float(np.sqrt(np.mean(np.sum(d * d, axis=1))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--cfg", default=default_cfg("rbphdslam_VictoriaPark.xml"))
    ap.add_argument("--data", required=True,
                    help="Victoria Park dataset directory (reference format)")
    ap.add_argument("--messages", type=int, default=None,
                    help="process only the first N sensor messages")
    ap.add_argument("--logdir", default=None)
    ap.add_argument("--particles", type=int, default=None)
    ap.add_argument("--map-capacity", type=int, default=512)
    ap.add_argument("--z-dp-max", type=int, default=8,
                    help="exact-DP column budget of the RFS likelihood "
                         "(reference approximates with Murty-200, "
                         "RBPHDFilter.hpp:920-959)")
    ap.add_argument("--seed", type=int, default=0)
    _vp_common.add_ckpt_args(ap)
    args = ap.parse_args(argv)

    cfg = XmlConfig(args.cfg)
    n_msgs = args.messages if args.messages is not None else cfg.get(
        "filter.nMsgToProcess", 0, int)
    filt, input_cov, ack = build(cfg, z_capacity=24,
                                 map_capacity=args.map_capacity,
                                 n_particles=args.particles,
                                 z_dp_max=args.z_dp_max)
    frames = vp_io.load(args.data, scale_ur=cfg.get("process.ur_scale", 1.0),
                        z_capacity=24, n_messages=n_msgs, ackerman=ack)
    F = len(frames.t)
    print(f"victoriapark: {F} lidar frames, P={filt.cfg.n_particles}, "
          f"scans={'yes' if frames.scans is not None else 'NO (LASER.txt absent)'}, "
          f"device={jax.devices()[0]}")

    clutter_added = cfg.get("measurements.addedClutter", 0.0)
    if args.ckpt_dir:
        os.makedirs(args.ckpt_dir, exist_ok=True)
    state, outs, wall = run(filt, input_cov, frames,
                            artificial_clutter=clutter_added, seed=args.seed,
                            ckpt_dir=args.ckpt_dir,
                            ckpt_every=args.ckpt_every, resume=args.resume)
    poses, weights, best, gm_mean, gm_cov, gm_w, gm_alive, parents = outs
    print(f"done: {F} frames in {wall:.1f}s ({F / wall:.1f} frames/s incl. compile)")

    # the reference logs the FINAL best particle's consistent history via the
    # Trajectory prev-chain (rbphdslam_VictoriaPark.cpp:631-660); reconstruct
    # it from the recorded resampling ancestry.
    best_poses = logs.ancestral_path(poses, parents, best[-1])
    rmse = gps_rmse(frames.t, best_poses, frames.gps)
    stepwise = poses[np.arange(F), best]
    rmse_stepwise = gps_rmse(frames.t, stepwise, frames.gps)
    dr_rmse = gps_rmse(frames.t, frames.dr_pose, frames.gps)
    print(f"trajectory RMSE vs GPS: {rmse:.2f} m  (per-step argmax: "
          f"{rmse_stepwise:.2f} m, dead reckoning: {dr_rmse:.2f} m)")

    logdir = args.logdir or cfg.get("logging.logDirPrefix",
                                    "data/VictoriaPark/rbphdslam/results/", str)
    if cfg.get("logging.logResultsToFile", 0, int) or args.logdir:
        logs.write_particle_poses(logdir, frames.t, poses, weights)
        logs.write_landmark_estimates(logdir, frames.t, best, gm_mean, gm_cov,
                                      gm_w, gm_alive)
        logs.write_trajectory(logdir, frames.t, best_poses)
        print(f"logs -> {logdir}")


if __name__ == "__main__":
    main()
