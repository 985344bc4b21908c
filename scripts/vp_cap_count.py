"""Count Murty child-cap truncation on the Victoria Park MH stream.

Round-4 verdict: ``murty_child_cap`` truncation was A/B-bounded on the 2-D
sim but never COUNTED on VP, whose dense tree clusters are precisely where
valid children could exceed the cap routinely.  This tool replays the DA
front half (predict substeps -> _da_table -> murty with return_nvalid) at
every kept checkpoint of an MH VP run and reports the distribution of
IN-WINDOW valid children per expansion wave vs the cap — i.e. how often the
cap actually binds after the round-5 dual-bound window pruning.

Run after an MH VP run with --ckpt-keep 0:

    python scripts/vp_cap_count.py <ckpt_dir> <VictoriaPark dataset dir> [cap]
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rfs_slam_tpu.utils import cache
cache.enable()

import jax
import jax.numpy as jnp
import numpy as np

from rfs_slam_tpu.apps import fastslam_victoriapark as fvp
from rfs_slam_tpu.io import victoria_park as vp_io
from rfs_slam_tpu.io.xmlconfig import XmlConfig, default_cfg
from rfs_slam_tpu.ops.assignment import murty
from rfs_slam_tpu.utils import checkpoint

ckpt_dir, data_dir = sys.argv[1], sys.argv[2]
cap = int(sys.argv[3]) if len(sys.argv) > 3 else 6

cfg = XmlConfig(default_cfg("mhfastslam_VictoriaPark.xml"))
filt, input_cov, ack = fvp.build(cfg, z_capacity=24, map_capacity=512,
                                 n_particles=None)
frames = vp_io.load(data_dir,
                    scale_ur=cfg.get("process.ur_scale", 1.0),
                    z_capacity=24, ackerman=ack)
H = filt.cfg.max_hypotheses
window = filt.cfg.max_da_loglik_diff
template = filt.init_state(jax.random.PRNGKey(0), jnp.zeros(3), d=3)

steps = sorted(
    int(n[5:-4]) for n in os.listdir(ckpt_dir)
    if n.startswith("ckpt_") and n.endswith(".npz"))
print(f"{len(steps)} checkpoints in {ckpt_dir}; H={H} window={window} "
      f"cap={cap} NMZ={filt.cfg.nmz_capacity}")


@jax.jit
def count_frame(state, pdt, pu, pnoise, z, zm):
    def substep(s, sub):
        dt, u, noise = sub
        return filt.predict(s, u, dt, use_model_noise=False,
                            use_input_noise=noise, input_cov=input_cov), None

    state, _ = jax.lax.scan(substep, state, (pdt, pu, pnoise))
    pose, gm = state.particles.pose, state.gm
    table, lm_idx, row_valid, pd_rank, close_rank, gate_tab = filt._da_table(
        pose, gm, z, zm)
    n_m = jnp.sum(row_valid, axis=1)
    nZ = jnp.sum(zm)
    _, _, _, nvalid = jax.vmap(
        lambda t, nr: murty(t, H, real_rows=nr, real_cols=nZ,
                            child_cap=cap, prune_window=window,
                            return_nvalid=True))(table, n_m)
    alive_p = jnp.isfinite(state.particles.log_w)
    return jnp.where(alive_p[:, None], nvalid, -1), n_m, alive_p


all_nvalid = []
all_nm = []
for s in steps:
    if s >= len(frames.t):
        continue
    _, state = checkpoint.restore(ckpt_dir, template, step=s)
    nv, n_m, alive_p = count_frame(
        state, jnp.asarray(frames.pred_dt[s], jnp.float32),
        jnp.asarray(frames.pred_u[s], jnp.float32),
        jnp.asarray(frames.pred_noise[s]),
        jnp.asarray(frames.z[s], jnp.float32),
        jnp.asarray(frames.z_mask[s]))
    nv = np.asarray(nv)
    all_nvalid.append(nv[nv >= 0])
    all_nm.append(np.asarray(n_m)[np.asarray(alive_p)])

nv = np.concatenate(all_nvalid)
nm = np.concatenate(all_nm)
print(f"{len(steps)} frames x alive lanes x {H - 1} waves = {nv.size} "
      f"expansion waves counted")
print(f"in-range landmarks/particle: p50 {np.percentile(nm, 50):.0f} "
      f"p90 {np.percentile(nm, 90):.0f} max {nm.max()}")
print(f"IN-WINDOW valid children/wave: p50 {np.percentile(nv, 50):.0f} "
      f"p90 {np.percentile(nv, 90):.0f} p99 {np.percentile(nv, 99):.0f} "
      f"max {nv.max()}")
binds = float(np.mean(nv > cap))
print(f"cap={cap} binds on {100 * binds:.2f}% of waves "
      f"(mean excess when binding: "
      f"{float(np.mean(np.maximum(nv - cap, 0)[nv > cap])) if binds else 0:.1f})")
for c in (4, 6, 8, 12, 17):
    print(f"  cap {c:2d} would bind on {100 * float(np.mean(nv > c)):6.2f}% "
          f"of waves")
