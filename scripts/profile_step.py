"""Per-phase device timing of the RB-PHD step at bench shapes.

Each phase is timed inside a lax.scan (N iterations in one dispatch) so the
number is device time, immune to host dispatch jitter.  For the device busy
time and idle share of the real bench scan use scripts/trace_step.py.

Not a test — a developer tool. Run: python scripts/profile_step.py
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rfs_slam_tpu.utils import cache
cache.enable()

import jax
import jax.numpy as jnp

import __graft_entry__ as ge
from rfs_slam_tpu.ops import gm as gm_ops
from rfs_slam_tpu.ops import resample as resample_ops
from rfs_slam_tpu.ops.ekf import correct_all

P, M, ZC = 200, 128, 40
N_ITER = 100

filt = ge._build(n_particles=P, map_capacity=M, z_capacity=ZC,
                 new_capacity=64, eval_capacity=15, z_dp_max=10)
key = jax.random.PRNGKey(0)
state, odo, z, z_mask = ge._example_inputs(filt, key)
z = jnp.tile(z[: ZC // 4], (4, 1))[:ZC]
z_mask = jnp.arange(ZC) < 10


def scan_time(name, step_fn, init_carry, n=N_ITER):
    """Time step_fn(carry) -> carry inside one lax.scan dispatch."""

    @jax.jit
    def run(c):
        return jax.lax.scan(lambda cc, _: (step_fn(cc), None), c, None,
                            length=n)[0]

    out = run(init_carry)
    jax.block_until_ready(out)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        out = run(init_carry)
        jax.block_until_ready(out)
        best = min(best, (time.perf_counter() - t0) / n)
    print(f"{name:30s} {best*1e3:8.3f} ms")
    return out


full_state = scan_time("predict", lambda s: filt.predict(s, odo, 0.1), state,
                       n=20)
scan_time("predict+update(step)",
          lambda s: filt.update(filt.predict(s, odo, 0.1), z, z_mask),
          state, n=20)

pose = full_state.particles.pose
gm = full_state.gm


def wrap_gm(fn):
    # carry the gm through the phase so scan iterations chain
    def step(g):
        out = fn(g)
        return out if isinstance(out, type(g)) else g.replace(w=g.w + out)
    return step


scan_time("  correct_all [P,Z,M] (lik sum)",
          wrap_gm(lambda g: jnp.sum(
              correct_all(filt.meas, filt.gates, pose, g.mean, g.cov, z
                          ).likelihood, axis=1) * 1e-6),
          gm)
scan_time("  merge", lambda g: gm_ops.merge(g, 0.5, 1.5), gm)
scan_time("  prune+compact",
          lambda g: gm_ops.compact(gm_ops.prune(g, 0.01), M), gm)
clutter_z = jnp.broadcast_to(filt.meas.clutter_intensity(z, 10), (ZC,))
scan_time("  importance (via w carry)",
          wrap_gm(lambda g: 1e-9 * filt._importance_weights(
              full_state.particles.log_w, pose, g, z, z_mask, clutter_z, 10
          )[:, None]),
          gm)
anc = jnp.arange(P, dtype=jnp.int32)[::-1]
scan_time("  resample gather",
          lambda g: resample_ops.gather_particles({"gm": g}, anc)["gm"], gm)


# ---- finer breakdown of the map-update + predict internals
def wtab_only(g):
    """correct_all + weight table + missed-detection weights (no new-Gaussian
    selection, no append)."""
    import jax.numpy as jnp
    from rfs_slam_tpu.core import planar
    cfg = filt.cfg
    corr = correct_all(filt.meas, filt.gates, pose, g.mean, g.cov, z)
    pd_raw, close = filt.meas.pd_p(pose[:, None, :], g.mean, g.cov)
    pd = jnp.where(close & g.alive, 1.0, jnp.where(g.alive, pd_raw, 0.0))
    md_gate = corr.md2 <= cfg.new_gaussian_md_threshold**2
    cell = (g.alive[:, None, :] & (pd[:, None, :] > 0.0)
            & z_mask[None, :, None] & md_gate & (corr.likelihood > 0.0))
    w_tab = jnp.where(cell, pd[:, None, :] * g.w[:, None, :] * corr.likelihood, 0.0)
    clutter_z = jnp.broadcast_to(filt.meas.clutter_intensity(z, 10), (ZC,))
    col_sum = clutter_z[None, :] + jnp.sum(w_tab, axis=2)
    w_tab = jnp.where(z_mask[None, :, None], w_tab / col_sum[:, :, None], 0.0)
    w_miss = (1.0 - pd) * g.w + jnp.sum(w_tab, axis=1) * 1e-9
    return g.replace(w=jnp.where(g.alive, w_miss + g.w * 0.999, g.w))


def map_update_full(g):
    st = full_state.replace(gm=g)
    gm_full, _, _, _, _ = filt._map_update(st, z, z_mask, filt.meas)
    return gm_ops.compact(gm_full, M)


scan_time("  wtab+missdetect (incl corr)", wtab_only, gm)
scan_time("  map_update full (corr..append)", map_update_full, gm)
scan_time("  append(48 new)+compact",
          lambda g: gm_ops.append(
              g, g.mean[:, :, :48], g.cov[:, :, :48], g.w[:, :48] * 0.5,
              g.alive[:, :48], capacity=M), gm)


def birth_only(g):
    st = full_state.replace(gm=g)
    gm2, _ = filt._add_birth_gaussians(st, jax.random.PRNGKey(1), filt.meas)
    return gm_ops.compact(gm2, M)


def propagate_only(g):
    import jax.numpy as jnp
    keys = jax.random.split(jax.random.PRNGKey(2), P)
    p2 = jax.vmap(lambda k, p: filt.motion.sample(k, p, odo, 0.1, True, False,
                                                  None))(keys, pose)
    return g.replace(w=g.w + jnp.sum(p2) * 1e-12)


scan_time("  birth gaussians only", birth_only, gm)
scan_time("  propagate only", propagate_only, gm)


# ---- selection-path microprobes
import jax.numpy as jnp  # noqa: E402


def topk_only(g):
    w_flat = (g.w[:, None, :] * jnp.ones((1, ZC, 1))).reshape(P, ZC * M)
    tw, ti = jax.lax.top_k(w_flat, 48)
    return g.replace(w=g.w + jnp.sum(tw, axis=1, keepdims=True) * 1e-12
                     + jnp.sum(ti, axis=1, keepdims=True) * 0.0)


def approx_topk_only(g):
    w_flat = (g.w[:, None, :] * jnp.ones((1, ZC, 1))).reshape(P, ZC * M)
    tw, ti = jax.lax.approx_max_k(w_flat, 48)
    return g.replace(w=g.w + jnp.sum(tw, axis=1, keepdims=True) * 1e-12
                     + jnp.sum(ti, axis=1, keepdims=True) * 0.0)


def replace_weakest_only(g):
    return gm_ops.replace_weakest(
        g, g.mean[:, :, :48], g.cov[:, :, :48], g.w[:, :48] * 0.5,
        g.alive[:, :48], sorted_desc=True)


scan_time("  topk 5120->48", topk_only, gm)
scan_time("  approx topk 5120->48", approx_topk_only, gm)
scan_time("  replace_weakest(48)", replace_weakest_only, gm)


# ---- calibration + predict decomposition
scan_time("  noop (scan overhead floor)",
          lambda g: g.replace(w=g.w + 1e-9), gm)
scan_time("  static step only",
          lambda g: g.replace(cov=filt.lmk.static_step_p(g.mean, g.cov, 0.1)[1]),
          gm)


def key_split_only(g):
    k1, k2, k3 = jax.random.split(jax.random.fold_in(
        jax.random.PRNGKey(0), jnp.int32(jnp.sum(g.w))), 3)
    ks = jax.random.split(k2, P)
    probe = jnp.sum(jax.random.key_data(ks).astype(jnp.float32))
    return g.replace(w=g.w + probe * 1e-30)


scan_time("  rng split P keys only", key_split_only, gm)
