"""Per-phase device timing of the Victoria Park RB-PHD frame.

Measures where the VP frame time goes (P=100, M=512, Zc=24, D=3) with the
in-context ablation method (remove one phase, keep the rest live):
standalone phase probes under-attribute because XLA dead-code-eliminates
whatever a probe does not consume.

Not a test — a developer tool.  Run:
    python scripts/profile_vp.py <VictoriaPark dataset dir> [n_warm]
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

from rfs_slam_tpu.apps import rbphdslam_victoriapark as app
from rfs_slam_tpu.io import victoria_park as vp_io
from rfs_slam_tpu.io.xmlconfig import XmlConfig, default_cfg
import rfs_slam_tpu.ops.gm as gm_module

DATA = sys.argv[1]
N_WARM = int(sys.argv[2]) if len(sys.argv) > 2 else 200

cfg = XmlConfig(default_cfg("rbphdslam_VictoriaPark.xml"))
filt, input_cov, ack = app.build(cfg, z_capacity=24, map_capacity=512,
                                 n_particles=100)
frames = vp_io.load(DATA,
                    scale_ur=cfg.get("process.ur_scale", 1.0),
                    z_capacity=24, n_messages=N_WARM * 12, ackerman=ack)
F = len(frames.t)
print(f"{F} frames loaded; P=100 M=512 Zc=24 D=3")


def make_step():
    def frame_step(state, inp):
        pdt, pu, pnoise, zf, zmf = inp

        def substep(s, sub):
            dt, u, noise = sub
            return filt.predict(s, u, dt, use_model_noise=False,
                                use_input_noise=noise,
                                input_cov=input_cov), None

        state, _ = jax.lax.scan(substep, state, (pdt, pu, pnoise))
        state = filt.update(state, zf, zmf)
        return state, None
    return frame_step


inputs = tuple(jnp.asarray(a) for a in (
    frames.pred_dt.astype(np.float32), frames.pred_u.astype(np.float32),
    frames.pred_noise, frames.z.astype(np.float32), frames.z_mask))

state = filt.init_state(jax.random.PRNGKey(0), jnp.zeros(3), dz=3, d=3)
step = make_step()

# warm to a realistic mid-run state
C = 64
t0 = time.perf_counter()
warm = min(N_WARM, F)
run_chunk = jax.jit(lambda s, ch: jax.lax.scan(step, s, ch)[0])
for f in range(0, warm, C):
    chunk = jax.tree_util.tree_map(lambda a: a[f:f + C], inputs)
    state = run_chunk(state, chunk)
jax.block_until_ready(state)
print(f"warmup {warm} frames: {time.perf_counter() - t0:.1f}s (incl. compile)")
print(f"mid-run alive landmarks: mean "
      f"{float(jnp.sum(state.gm.alive, axis=1).mean()):.0f}, max "
      f"{int(jnp.sum(state.gm.alive, axis=1).max())}")

probe = jax.tree_util.tree_map(lambda a: a[warm:warm + 16], inputs)


def timed(name, fn):
    run = jax.jit(lambda s: jax.lax.scan(fn, s, probe)[0])
    out = jax.block_until_ready(run(state))
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(run(state))
        best = min(best, (time.perf_counter() - t0) / 16)
    print(f"{name:44s} {best * 1e3:9.2f} ms/frame")
    return out


timed("full frame (predict substeps + update)", step)

# ---- ablations
real_merge = gm_module.merge
gm_module.merge = lambda gm, *a, **k: gm
timed("  skip GM merge", make_step())
gm_module.merge = real_merge

real_imp = filt._importance_weights
filt._importance_weights = lambda log_w, *a, **k: log_w
timed("  skip importance weighting", make_step())
filt._importance_weights = real_imp

real_upd = filt._update_body
filt._update_body = lambda s, z, zm, meas=None: s
timed("  predict substeps only (skip update)", make_step())
filt._update_body = real_upd


def no_resample(state, gm_full, log_w, unused, n_in_fov, z, z_mask, nZ):
    return state.replace(gm=gm_full)


real_rs = filt._resample_phase
filt._resample_phase = no_resample
timed("  skip resample phase", make_step())
filt._resample_phase = real_rs

# ---- merge internals at this mid-run state
from rfs_slam_tpu.ops import gm as gm_ops

mt = filt.cfg.merge_threshold
mi = filt.cfg.merge_inflation
gm0 = state.gm


def timed_gm(name, fn):
    run = jax.jit(lambda g: jax.lax.scan(
        lambda gg, _: (fn(gg).replace(mean=gg.mean * 1.0001), None),
        g, None, length=16)[0])
    jax.block_until_ready(run(gm0))
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(run(gm0))
        best = min(best, (time.perf_counter() - t0) / 16)
    print(f"{name:44s} {best * 1e3:9.2f} ms")


timed_gm("gm compact (sort+take_slots) only", lambda g: gm_ops.compact(g, 512))
timed_gm("merge() (compact + fixpoint)",
         lambda g: gm_ops.merge(g, mt, mi))
