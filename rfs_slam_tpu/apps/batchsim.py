"""batchsim — parameter-sweep regression harness.

Equivalent of the reference's ``scripts/batchSim/batchSim_*.bash``
(batchSim_rbphdslam.bash:9-40): sweep P_D x clutter x seeds on the 2-D sim,
run the filter + analysis per combo, and append the FINAL pose / map errors
to a results file (the de-facto regression suite, SURVEY.md section 4).

Fixed shapes make the sweep cheap: every combo reuses the same compiled
whole-run scan (P_D / clutter / seed are runtime values, not trace
constants).  The default config is the filter's file in the repository's
``cfg/`` directory.

Usage::

    python -m rfs_slam_tpu.apps.batchsim --cfg cfg/rbphdslam2dSim.xml \
        --filter rbphd --pd 0.99 0.9 0.75 --clutter 1e-4 1e-3 \
        --seeds 3 --steps 500 --out results_rbphd.dat
"""

from __future__ import annotations

import argparse
import dataclasses
import time

from rfs_slam_tpu.utils import cache

cache.enable()

import numpy as np

from rfs_slam_tpu.io import sim2d
from rfs_slam_tpu.io.xmlconfig import XmlConfig, default_cfg, load_sim2d


def final_map_cola(filter_kind, data, sim_cfg, gm_mean, gm_w, gm_alive,
                   w_threshold=0.75, cutoff=0.2, order=1.0):
    """COLA map error of the final best-particle map estimate vs the
    groundtruth landmarks observable by then (the reference's mapError
    column, batchSim_rbphdslam.bash:36 via analysis2dSim.cpp:182-247;
    c=0.2, p=1, estimate threshold w >= 0.75).

    FastSLAM maps carry log-odds existence weights — thresholded at the
    same 0.75 on the PROBABILITY scale (w >= logit(0.75))."""
    from rfs_slam_tpu.apps.analysis2dsim import cola_error

    w = np.asarray(gm_w[-1], np.float64)
    if filter_kind != "rbphd":
        w = 1.0 / (1.0 + np.exp(-w))          # log-odds -> probability
    keep = np.asarray(gm_alive[-1]) & (w >= w_threshold)
    est = np.asarray(gm_mean[-1])[keep]
    t_end = (sim_cfg.timesteps - 1) * sim_cfg.dt
    obs = (data.lmk_first_obs >= 0) & (data.lmk_first_obs <= t_end)
    return float(cola_error(est, data.landmarks[obs], cutoff=cutoff,
                            order=order))


def run_one(filter_kind, cfg, sim_cfg, traj_seed, noise_seed, z_capacity,
            n_particles):
    try:
        data = sim2d.generate(sim_cfg, traj_seed=traj_seed,
                              noise_seed=noise_seed, z_capacity=z_capacity)
    except ValueError:
        # high-clutter cells overflow the default capacity; learn the
        # natural max and bucket it (multiples of 16 bound the number of
        # distinct compiled shapes across the sweep)
        probe = sim2d.generate(sim_cfg, traj_seed=traj_seed,
                               noise_seed=noise_seed, z_capacity=None)
        z_capacity = max(z_capacity, -(-probe.z.shape[1] // 16) * 16)
        data = sim2d.generate(sim_cfg, traj_seed=traj_seed,
                              noise_seed=noise_seed, z_capacity=z_capacity)
    if filter_kind == "rbphd":
        from rfs_slam_tpu.apps import rbphdslam2dsim as app
    else:
        from rfs_slam_tpu.apps import fastslam2dsim as app
    filt = app.build_filter_from_xml(cfg, sim_cfg, z_capacity=z_capacity,
                                     n_particles=n_particles)
    _, outs, wall = app.run(filt, sim_cfg, data)
    poses, weights, best, gm_mean, gm_cov, gm_w, gm_alive = outs
    T = sim_cfg.timesteps
    # final-quarter errors (the reference batch scripts record the tail)
    k0 = (3 * (T - 1)) // 4
    best_pose = poses[np.arange(T - 1), best]
    err = np.linalg.norm(best_pose[k0:, :2] - data.gt_pose[1 + k0:, :2],
                         axis=1)
    map_err = final_map_cola(filter_kind, data, sim_cfg, gm_mean, gm_w,
                             gm_alive)
    return float(np.mean(err)), float(err[-1]), map_err, wall


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--cfg", default=None,
                    help="default: cfg/rbphdslam2dSim.xml or "
                         "cfg/fastslam2dSim.xml, by --filter")
    ap.add_argument("--filter", choices=["rbphd", "fastslam"], default="rbphd")
    ap.add_argument("--pd", type=float, nargs="+",
                    default=[0.99, 0.95, 0.9, 0.75, 0.5])
    ap.add_argument("--clutter", type=float, nargs="+",
                    default=[1e-4, 1e-3, 1e-2])
    ap.add_argument("--seeds", type=int, default=10)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--particles", type=int, default=None)
    ap.add_argument("--out", default="batchResults.dat")
    ap.add_argument("--zc", type=int, default=48,
                    help="measurement capacity (auto-raised per cell when a "
                         "high-clutter sim overflows it)")
    ap.add_argument("--seed-offset", type=int, default=0)
    args = ap.parse_args(argv)

    if args.cfg is None:
        args.cfg = default_cfg("rbphdslam2dSim.xml" if args.filter == "rbphd"
                               else "fastslam2dSim.xml")
    cfg = XmlConfig(args.cfg)
    base = load_sim2d(cfg)
    if args.steps:
        base = dataclasses.replace(base, timesteps=args.steps)
    zc = args.zc

    n = 0
    with open(args.out, "a") as f:
        f.write(f"# filter={args.filter} cfg={args.cfg} "
                f"steps={base.timesteps}\n")
        f.write("# pd  clutter  seed  meanTailErr  finalErr  mapCola  wall_s\n")
        for pd in args.pd:
            for clutter in args.clutter:
                sim_cfg = dataclasses.replace(base, pd=pd, clutter=clutter)
                for seed in range(args.seed_offset,
                                  args.seed_offset + args.seeds):
                    t0 = time.time()
                    mean_err, final_err, map_err, wall = run_one(
                        args.filter, cfg, sim_cfg, traj_seed=seed,
                        noise_seed=seed + 1, z_capacity=zc,
                        n_particles=args.particles)
                    f.write(f"{pd:.4f}  {clutter:.6g}  {seed}  "
                            f"{mean_err:.6f}  {final_err:.6f}  "
                            f"{map_err:.6f}  {wall:.2f}\n")
                    f.flush()
                    n += 1
                    print(f"[{n}] pd={pd} clutter={clutter} seed={seed}: "
                          f"tail err {mean_err:.3f} m, map COLA "
                          f"{map_err:.2f} ({time.time() - t0:.1f}s)")
    print(f"results -> {args.out}")


if __name__ == "__main__":
    main()
