"""Benchmark: RB-PHD SLAM, reference rbphdslam2dSim workload, on one GPU.

Workload anchors (BASELINE.md): 3000 timesteps, 200 particles, 50 landmarks,
P_D 0.99, clutter 1e-4 (cfg/rbphdslam2dSim.xml).  The metric is filter
timesteps/second for the full pipeline (predict + births + batched EKF map
update + importance weighting with the exact RFS likelihood + merge + prune +
ESS-gated resampling), steady-state (post-compile), whole-run scan on device,
each run timed to ``jax.block_until_ready``.

``vs_baseline`` compares against the OpenMP C++ baseline (``native/baseline``,
same workload, double precision, all cores) only when that binary has been
run on this host and left ``native/baseline_result.json``; otherwise it is
null.  The bench never builds or runs the baseline itself.

Prints the device (JAX platform, device kind, count, and the card's name and
power limit from nvidia-smi), then ONE json line: {"metric", "value",
"unit", "vs_baseline", "detail"}.  Exits non-zero when the default JAX
backend is not a GPU, or when an accuracy gate fails.
"""

import json
import os
import sys
import time

from rfs_slam_tpu.utils import cache

cache.enable()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from rfs_slam_tpu.filters.rbphd import RBPHDConfig, RBPHDFilter  # noqa: E402
from rfs_slam_tpu.io import sim2d  # noqa: E402
from rfs_slam_tpu.models.motion import Odometry2D, StaticLandmark  # noqa: E402
from rfs_slam_tpu.models.measurement import RangeBearing  # noqa: E402
from rfs_slam_tpu.ops.ekf import InnovationGates  # noqa: E402
from rfs_slam_tpu.utils import device  # noqa: E402

N_PARTICLES = 200
T = 3000
Z_CAPACITY = 40
MAP_CAPACITY = 128
GT_LOCK_STEPS = 100
HERE = os.path.dirname(os.path.abspath(__file__))


def build(n_particles: int = N_PARTICLES):
    sim_cfg = sim2d.Sim2DConfig()  # the rbphdslam2dSim.xml defaults
    data = sim2d.generate(sim_cfg, traj_seed=1, noise_seed=1,
                          z_capacity=Z_CAPACITY)
    dt = sim_cfg.dt
    motion = Odometry2D(
        Q=np.diag(np.asarray([sim_cfg.vardx, sim_cfg.vardy, sim_cfg.vardz]))
        * (1.5 * dt * dt)
    )
    lmk = StaticLandmark(
        Q=np.diag(np.asarray([sim_cfg.varlmx, sim_cfg.varlmy])) * dt * dt
    )
    meas = RangeBearing(
        R=np.diag(np.asarray([sim_cfg.varzr, sim_cfg.varzb])) * 10.0,
        pd_const=sim_cfg.pd, clutter=sim_cfg.clutter,
        r_max=sim_cfg.range_max, r_min=sim_cfg.range_min,
        r_buf=sim_cfg.range_buffer,
    )
    gates = InnovationGates.range_bearing(range_t=1.0, bearing_t=0.2)
    cfg = RBPHDConfig(
        n_particles=n_particles, map_capacity=MAP_CAPACITY,
        z_capacity=Z_CAPACITY, new_capacity=48, new_per_z=8, birth_capacity=16,
        eval_capacity=15, z_dp_max=10,
        birth_gaussian_weight=0.01, new_gaussian_md_threshold=3.0,
        eval_pt_min_weight=0.75, weighting_md_threshold=3.0,
        merge_threshold=0.5, merge_inflation=1.5, prune_threshold=0.01,
        min_updates_before_resample=2, ess_threshold=n_particles / 2.0,
    )
    filt = RBPHDFilter(motion, lmk, meas, gates, cfg)
    return sim_cfg, data, filt


def make_run(filt, dt):
    """``run(state, inputs) -> (state, best_pose [T-1, 3])``: the whole-run
    scan the bench compiles (gt-locked for the first GT_LOCK_STEPS)."""

    def step(state, inp):
        odo, z, z_mask, gt, lock = inp
        state = filt.predict(state, odo, dt)
        pose = jnp.where(
            lock, jnp.broadcast_to(gt, state.particles.pose.shape),
            state.particles.pose,
        )
        state = state.replace(particles=state.particles.replace(pose=pose))
        state = filt.update(state, z, z_mask)
        best = jnp.argmax(state.particles.log_w)
        return state, state.particles.pose[best]

    def run(state, inputs):
        return jax.lax.scan(step, state, inputs)

    return run


def scan_inputs(odometry, z, z_mask, gt_pose):
    """Per-step scan inputs from [T, ...] arrays (step 0 is the prior)."""
    n = len(odometry)
    return (
        jnp.asarray(odometry[1:], jnp.float32),
        jnp.asarray(z[1:], jnp.float32),
        jnp.asarray(z_mask[1:]),
        jnp.asarray(gt_pose[1:], jnp.float32),
        jnp.arange(1, n) <= GT_LOCK_STEPS,
    )


def pose_err(best_poses, gt_pose) -> float:
    """Median best-particle position error over steps >= 150."""
    err = np.linalg.norm(np.asarray(best_poses)[:, :2] - gt_pose[1:, :2],
                         axis=1)
    return float(np.median(err[150:]))


def timed(compiled, state, inputs):
    """Run a compiled scan to completion; returns (seconds, outputs)."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(compiled(state, inputs))
    return time.perf_counter() - t0, out


def run_bench(sim_cfg, data, filt):
    state = filt.init_state(jax.random.PRNGKey(0), jnp.zeros(3))
    inputs = scan_inputs(data.odometry, data.z, data.z_mask, data.gt_pose)

    t0 = time.perf_counter()
    compiled = jax.jit(make_run(filt, sim_cfg.dt)).lower(
        state, inputs).compile()
    compile_s = time.perf_counter() - t0

    first_run_s, out = timed(compiled, state, inputs)
    errs = [pose_err(out[1], data.gt_pose)]

    # ---- second, DETERMINISTIC accuracy gate: replay the committed C++
    # baseline dump (native/bl_dump, written by `native/baseline --dump`)
    # through the same compiled executable (identical shapes, zero extra
    # compile).  Fixed data + fixed PRNGKey(0) makes this nearly noise-free,
    # unlike the 4-seed median below, whose run-level spread is
    # ~0.05-0.17 m on this chaotic resampling workload.
    id_gt, id_inputs = load_identical_data()
    identical_s, id_out = timed(compiled, state, id_inputs)
    identical_err = pose_err(id_out[1], id_gt)

    # 3 more timed runs with DIFFERENT filter init seeds: the accuracy
    # metric is the median over the 4 runs (a single-seed median pose error
    # spans ~0.05-0.17 m across seeds and moves under 1-ulp arithmetic
    # changes, so gating a single draw would make the gate a coin flip).
    times = []
    for seed in range(2, 5):
        s2 = filt.init_state(jax.random.PRNGKey(seed), jnp.zeros(3))
        dt_, out = timed(compiled, s2, inputs)
        times.append(dt_)
        errs.append(pose_err(out[1], data.gt_pose))
    best_t = min(times)

    return {
        "timesteps_per_sec": (T - 1) / best_t,
        "wall_s": best_t,
        "compile_s": compile_s,
        "first_run_s": first_run_s,
        "median_pose_err_m": float(np.median(errs)),
        "pose_err_runs_m": [round(e, 4) for e in errs],
        "identical_data_err_m": identical_err,
        "identical_data_s": identical_s,
    }


def load_identical_data():
    """The committed C++ baseline dump as bench-shaped scan inputs."""
    d = os.path.join(HERE, "native", "bl_dump")
    go = np.loadtxt(os.path.join(d, "gt_odo.txt"))
    gt, odo = go[:, :3], go[:, 3:]
    z = np.zeros((T, Z_CAPACITY, 2), np.float32)
    z_mask = np.zeros((T, Z_CAPACITY), bool)
    counts = np.zeros(T, np.int32)
    for k, r, b in np.loadtxt(os.path.join(d, "z.txt")):
        k = int(k)
        if counts[k] < Z_CAPACITY:
            z[k, counts[k]] = (r, b)
            z_mask[k, counts[k]] = True
            counts[k] += 1
    return gt, scan_inputs(odo, z, z_mask, gt)


def baseline_tps():
    """OpenMP C++ baseline timesteps/s, if ``native/baseline`` was run on
    this host (it writes ``native/baseline_result.json``); else None."""
    result_file = os.path.join(HERE, "native", "baseline_result.json")
    if not os.path.exists(result_file):
        return None
    with open(result_file) as f:
        return json.load(f)["timesteps_per_sec"]


# Accuracy anchors.  Two gates:
#
# 1. ACCURACY_ANCHOR_M — the MEDIAN over the bench's 4 runs (4 filter init
#    seeds).  The single-seed spread is 0.056-0.166 m (6 seeds), wider than
#    a tight gate, so single-draw gating would be a coin flip.  The 4-seed
#    median operating point is ~0.09-0.11 m after the mass-conserving merge
#    fix; the gate sits ~1.4x above it.
# 2. IDENTICAL_DATA_ANCHOR_M — deterministic replay of the committed C++
#    dump (native/bl_dump, fixed data + fixed seed; run-to-run noise ~0).
#    Operating point ~0.06 m (RESULTS.md; the C++ double baseline scores
#    0.574 m on this same data).  Gate = ~2x the operating point.  This is
#    the low-variance regression anchor; it does NOT move when the 4-seed
#    gate is re-fit.
ACCURACY_ANCHOR_M = 0.15
IDENTICAL_DATA_ANCHOR_M = 0.12


def main():
    dev = device.require_gpu("bench")
    print(f"bench: device {dev}", flush=True)
    sim_cfg, data, filt = build()
    stats = run_bench(sim_cfg, data, filt)
    base = baseline_tps()
    vs = stats["timesteps_per_sec"] / base if base else None
    accuracy_ok = stats["median_pose_err_m"] <= ACCURACY_ANCHOR_M
    identical_ok = stats["identical_data_err_m"] <= IDENTICAL_DATA_ANCHOR_M
    print(json.dumps({
        "metric": "rbphd2dsim_200p_timesteps_per_sec",
        "value": round(stats["timesteps_per_sec"], 2),
        "unit": "timesteps/s",
        "vs_baseline": round(vs, 2) if vs else None,
        "detail": {
            "compile_s": round(stats["compile_s"], 1),
            "first_run_s": round(stats["first_run_s"], 1),
            "wall_s": round(stats["wall_s"], 3),
            "median_pose_err_m": round(stats["median_pose_err_m"], 4),
            "pose_err_runs_m": stats["pose_err_runs_m"],
            "accuracy_anchor_m": ACCURACY_ANCHOR_M,
            "accuracy_ok": accuracy_ok,
            "identical_data_err_m": round(stats["identical_data_err_m"], 4),
            "identical_data_anchor_m": IDENTICAL_DATA_ANCHOR_M,
            "identical_data_ok": identical_ok,
            "baseline_timesteps_per_sec": base,
            "device": dev,
        },
    }))
    if not (accuracy_ok and identical_ok):
        sys.exit(1)


if __name__ == "__main__":
    main()
