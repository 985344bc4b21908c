"""How many MH particle lanes are ambiguous, per step, over a real run.

Sizes ``FastSLAMConfig.murty_lane_budget``: murty_gated runs the full Murty
expansion only on lanes whose root dual bound admits a SECOND hypothesis
inside ``maxDataAssocLogLikelihoodDiff`` (ops/assignment.ambiguous_lanes);
every other lane is certified single-hypothesis and exact.  This steps the
real MH filter on the 2-D sim and records the per-step ambiguous-lane count,
so the budget can be set at/above the observed tail instead of guessed.

Not a test — a developer tool. Run: python scripts/mh_ambiguity_probe.py
Env: MH_PROBE_STEPS (default 400), MH_CFG (default mhfastslam2dSim.xml).
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rfs_slam_tpu.utils import cache
cache.enable()

import jax
import jax.numpy as jnp
import numpy as np

from rfs_slam_tpu.apps.fastslam2dsim import build_filter_from_xml
from rfs_slam_tpu.io import sim2d
from rfs_slam_tpu.io.xmlconfig import XmlConfig, default_cfg, load_sim2d
from rfs_slam_tpu.ops.assignment import ambiguous_lanes

CFG = os.environ.get("MH_CFG", default_cfg("mhfastslam2dSim.xml"))
STEPS = int(os.environ.get("MH_PROBE_STEPS", "400"))
CHUNK = 50

cfg = XmlConfig(CFG)
sim_cfg = load_sim2d(cfg)
data = sim2d.generate(sim_cfg, traj_seed=0, noise_seed=0)
zc = data.z.shape[1]
filt = build_filter_from_xml(cfg, sim_cfg, z_capacity=max(zc, 4))
c = filt.cfg
print(f"shapes: P_cap={filt.p_cap} H={c.max_hypotheses} "
      f"NMZ={c.nmz_capacity} window={c.max_da_loglik_diff}")

state = filt.init_state(jax.random.PRNGKey(0), jnp.zeros(3))


@jax.jit
def chunk_run(state, inp):
    def step(s, one):
        odo, z, z_mask, gt, lock = one
        s = filt.predict(s, odo, sim_cfg.dt)
        pose = jnp.where(lock, jnp.broadcast_to(gt, s.particles.pose.shape),
                         s.particles.pose)
        s = s.replace(particles=s.particles.replace(pose=pose))
        # ambiguity BEFORE the update consumes the table (same state murty
        # sees inside the update)
        table, _, row_valid, _, _, _ = filt._da_table(pose, s.gm, z, z_mask)
        n_amb = jnp.sum(ambiguous_lanes(
            table, jnp.sum(row_valid, axis=1), jnp.sum(z_mask),
            c.max_da_loglik_diff))
        s = filt.update(s, z, z_mask)
        return s, n_amb

    return jax.lax.scan(step, state, inp)


counts = []
t0 = time.time()
for lo in range(1, STEPS + 1, CHUNK):
    hi = min(lo + CHUNK, STEPS + 1)
    sl = slice(lo, hi)
    inp = (
        jnp.asarray(data.odometry[sl], jnp.float32),
        jnp.asarray(data.z[sl], jnp.float32),
        jnp.asarray(data.z_mask[sl]),
        jnp.asarray(data.gt_pose[sl], jnp.float32),
        jnp.arange(lo, hi) <= 100,
    )
    state, n_amb = chunk_run(state, inp)
    counts.append(np.asarray(n_amb))
    print(f"  steps {lo}-{hi - 1}: chunk max ambiguous "
          f"{int(counts[-1].max())}", flush=True)

counts = np.concatenate(counts)
print(f"\nambiguous lanes over {STEPS} steps of P_cap={filt.p_cap} "
      f"({time.time() - t0:.0f}s):")
print(f"  mean {counts.mean():.1f}  p50 {np.percentile(counts, 50):.0f}  "
      f"p90 {np.percentile(counts, 90):.0f}  p99 "
      f"{np.percentile(counts, 99):.0f}  max {counts.max()}")
for b in (48, 64, 96, 128, 192):
    frac = float((counts > b).mean())
    print(f"  budget {b:4d}: overflows on {100 * frac:.1f}% of steps")
