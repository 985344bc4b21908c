"""Run the RB-PHD filter on the C++ baseline's EXACT sim data.

``native/baseline --dump <dir>`` writes its generated ground truth, odometry
and measurement stream; this script replays them through the JAX filter at
bench configuration and reports the same metric (median best-particle
position error over steps >= 150).  Removes data-generation RNG differences
from the JAX-vs-C++ accuracy comparison.

Run: python scripts/sim_accuracy_check.py [dump_dir] [--cpu]
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rfs_slam_tpu.utils import cache

cache.enable()


import jax
import jax.numpy as jnp
import numpy as np

import bench

# default to the dump committed for the bench's deterministic gate
dump = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "native", "bl_dump")
T, ZC = bench.T, bench.Z_CAPACITY

go = np.loadtxt(os.path.join(dump, "gt_odo.txt"))
gt, odo = go[:, :3], go[:, 3:]
zr = np.loadtxt(os.path.join(dump, "z.txt"))
z = np.zeros((T, ZC, 2), np.float32)
z_mask = np.zeros((T, ZC), bool)
counts = np.zeros(T, np.int32)
for k, r, b in zr:
    k = int(k)
    if counts[k] < ZC:
        z[k, counts[k]] = (r, b)
        z_mask[k, counts[k]] = True
        counts[k] += 1

_, _, filt = bench.build()


def run():
    state = filt.init_state(jax.random.PRNGKey(0), jnp.zeros(3))

    def step(state, inp):
        o, zz, zm, g, lock = inp
        state = filt.predict(state, o, 0.1)
        pose = jnp.where(lock, jnp.broadcast_to(g, state.particles.pose.shape),
                         state.particles.pose)
        state = state.replace(particles=state.particles.replace(pose=pose))
        state = filt.update(state, zz, zm)
        best = jnp.argmax(state.particles.log_w)
        return state, state.particles.pose[best]

    inputs = (
        jnp.asarray(odo[1:], jnp.float32),
        jnp.asarray(z[1:]),
        jnp.asarray(z_mask[1:]),
        jnp.asarray(gt[1:], jnp.float32),
        jnp.arange(1, T) <= 100,
    )
    state, best_poses = jax.jit(
        lambda s, i: jax.lax.scan(step, s, i))(state, inputs)
    return np.asarray(best_poses)


best_poses = run()
err = np.linalg.norm(best_poses[:, :2] - gt[1:, :2], axis=1)
print(f"median_pose_err_m(steps>=150) = {np.median(err[150:]):.4f}  "
      f"(C++ baseline on same data: run native/baseline --dump)")
print(f"p90 = {np.percentile(err[150:], 90):.4f}  max = {err[150:].max():.4f}")
