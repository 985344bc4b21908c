"""Per-phase device timing of the MH-FastSLAM update at 2-D sim shapes.

Round-4 follow-up to scripts/profile_step.py (which profiles the RB-PHD
step): the MH 2-D sim ran 36x FastSLAM 1.0's wall time at H=3 where the
reference pays ~H x — this breaks the MH update into its phases to find the
cost center.  Each phase is timed inside a lax.scan so the number is device
time.

Not a test — a developer tool. Run: python scripts/profile_mh.py
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
from rfs_slam_tpu.ops.assignment import hungarian, murty

CFG = os.environ.get("MH_CFG", default_cfg("mhfastslam2dSim.xml"))
WARM_STEPS = int(os.environ.get("MH_WARM_STEPS", "30"))

cfg = XmlConfig(CFG)
sim_cfg = load_sim2d(cfg)
data = sim2d.generate(sim_cfg, traj_seed=0, noise_seed=0)
zc = data.z.shape[1]
filt = build_filter_from_xml(cfg, sim_cfg, z_capacity=max(zc, 4))
c = filt.cfg
print(f"shapes: P={c.n_particles} P_cap={filt.p_cap} H={c.max_hypotheses} "
      f"NMZ={c.nmz_capacity} Zc={max(zc, 4)} M={c.map_capacity}")

# ---- build a realistic mid-stream state (gt-locked warmup)
state = filt.init_state(jax.random.PRNGKey(0), jnp.zeros(3))


@jax.jit
def step(state, inp):
    odo, z, z_mask, gt, lock = inp
    state = filt.predict(state, odo, sim_cfg.dt)
    pose = jnp.where(lock, jnp.broadcast_to(gt, state.particles.pose.shape),
                     state.particles.pose)
    state = state.replace(particles=state.particles.replace(pose=pose))
    return filt.update(state, z, z_mask), None


t0 = time.perf_counter()
for t in range(1, WARM_STEPS + 1):
    state, _ = step(state, (
        jnp.asarray(data.odometry[t], jnp.float32),
        jnp.asarray(data.z[t], jnp.float32),
        jnp.asarray(data.z_mask[t]),
        jnp.asarray(data.gt_pose[t], jnp.float32),
        jnp.asarray(t <= 20),
    ))
jax.block_until_ready(state)
print(f"warmup {WARM_STEPS} steps: {time.perf_counter() - t0:.1f}s "
      f"(incl. compile)")

t = WARM_STEPS + 1
odo = jnp.asarray(data.odometry[t], jnp.float32)
z = jnp.asarray(data.z[t], jnp.float32)
z_mask = jnp.asarray(data.z_mask[t])
print(f"nZ at probe step: {int(z_mask.sum())}")


def scan_time(name, step_fn, init_carry, n=20):
    @jax.jit
    def run(cc):
        return jax.lax.scan(lambda s, _: (step_fn(s), None), cc, None,
                            length=n)[0]

    out = run(init_carry)
    jax.block_until_ready(out)
    best = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        out = jax.block_until_ready(run(init_carry))
        best = min(best, (time.perf_counter() - t0) / n)
    print(f"{name:42s} {best*1e3:9.3f} ms")
    return out


# ---- full step
scan_time("predict+update (full MH step)",
          lambda s: step(s, (odo, z, z_mask, odo, False))[0], state, n=4)

# ---- DA table
pose = state.particles.pose
gm = state.gm
table, lm_idx, row_valid, pd_rank, close_rank, gate_tab = jax.jit(
    lambda p, g: filt._da_table(p, g, z, z_mask))(pose, gm)
jax.block_until_ready(table)


def da_table_phase(g):
    tab, *_ = filt._da_table(pose, g, z, z_mask)
    return g.replace(w=g.w + 1e-12 * jnp.sum(tab, axis=(1, 2))[:, None])


scan_time("_da_table (in-range compact + EKF table)", da_table_phase, gm,
          n=20)

# ---- murty k-best (the suspected cost center)
n_m = jnp.sum(row_valid, axis=1)
nZ = jnp.sum(z_mask)
H = c.max_hypotheses


def murty_phase(tab):
    das, scores, valid = jax.vmap(
        lambda tt, nr: murty(tt, H, real_rows=nr, real_cols=nZ)
    )(tab, n_m)
    return tab + 1e-12 * (jnp.sum(das, axis=(1, 2), dtype=tab.dtype)
                          + jnp.sum(scores, axis=1))[:, None, None]


scan_time("murty k-best (vmapped, H solves)", murty_phase, table, n=4)

# ---- round-5 variants: child_cap x dual-bound window pruning
for cap, win in [(12, None), (12, 3.0), (8, 3.0), (6, 3.0), (4, 3.0)]:
    def murty_v(tab, cap=cap, win=win):
        das, scores, valid = jax.vmap(
            lambda tt, nr: murty(tt, H, real_rows=nr, real_cols=nZ,
                                 child_cap=cap, prune_window=win)
        )(tab, n_m)
        return tab + 1e-12 * (jnp.sum(das, axis=(1, 2), dtype=tab.dtype)
                              + jnp.sum(scores, axis=1))[:, None, None]

    scan_time(f"murty cap={cap} window={win}", murty_v, table, n=4)


# ---- round-5b: lane-gated murty (root for all lanes; expansion only on
# lanes whose dual bound admits a 2nd in-window hypothesis)
from rfs_slam_tpu.ops.assignment import murty_gated  # noqa: E402

_, _, _, ovf1 = jax.jit(lambda t: murty_gated(
    t, H, n_m, real_cols=nZ, child_cap=c.murty_child_cap, prune_window=3.0,
    budget=1, return_overflow=True))(table)
print(f"ambiguous lanes at probe state (window 3.0): {int(ovf1) + 1} "
      f"of {table.shape[0]}")

for budget in (64, 96, 128, 192):
    def murty_g(tab, budget=budget):
        das, scores, valid, ovf = murty_gated(
            tab, H, n_m, real_cols=nZ, child_cap=c.murty_child_cap,
            prune_window=3.0, budget=budget, return_overflow=True)
        return tab + 1e-12 * (jnp.sum(das, axis=(1, 2), dtype=tab.dtype)
                              + jnp.sum(scores, axis=1)
                              + ovf.astype(tab.dtype))[:, None, None]

    scan_time(f"murty gated budget={budget} (cap=6, win=3.0)", murty_g,
              table, n=4)


def hung_phase(tab):
    sol, tot = jax.vmap(hungarian)(tab)
    return tab + 1e-12 * (jnp.sum(sol, axis=1, dtype=tab.dtype)
                          + tot)[:, None, None]


scan_time("hungarian (vmapped, 1 solve)", hung_phase, table, n=4)

# ---- remainder of the grow-mode update (everything after murty):
# monkey-time by running _update_body_mh_grow with a precomputed DA table
das, scores, valid = jax.jit(jax.vmap(
    lambda tt, nr: murty(tt, H, real_rows=nr, real_cols=nZ)))(table, n_m)
jax.block_until_ready(das)


def post_murty_phase(s):
    import rfs_slam_tpu.filters.fastslam as fs
    # replicate _update_body_mh_grow but with frozen murty outputs
    cfg_ = filt.cfg
    P_cap = s.particles.pose.shape[0]
    keep = valid & (scores[:, :1] - scores <= cfg_.max_da_loglik_diff)
    alive_p = jnp.isfinite(s.particles.log_w)
    keep = keep & alive_p[:, None]
    keep = keep.at[:, 0].set(alive_p)
    n_h = jnp.maximum(jnp.sum(keep, axis=1), 1)
    rows = jnp.arange(P_cap)[:, None]
    ranks = jnp.arange(cfg_.nmz_capacity)[None, :]
    Zc = z.shape[0]
    zmask_pad = jnp.zeros((cfg_.nmz_capacity,), bool).at[:Zc].set(z_mask)
    L_sums = []
    for h in range(H):
        da_h = das[:, h, :]
        L_da = table[rows, ranks, da_h]
        ok = (row_valid & (da_h < Zc) & zmask_pad[da_h]
              & (L_da > cfg_.min_log_likelihood)
              & gate_tab[rows, ranks, da_h])
        L_sums.append(jnp.sum(jnp.where(ok, L_da, 0.0), axis=1))
    L_sum = jnp.stack(L_sums, axis=1)
    hyp_lw = jnp.where(keep, s.particles.log_w[:, None]
                       - jnp.log(n_h)[:, None] + L_sum, -jnp.inf)
    flat_lw = hyp_lw.T.reshape(-1)
    from rfs_slam_tpu.ops import resample as resample_ops
    key, k_rs = jax.random.split(s.particles.key)
    anc = jnp.pad(resample_ops.systematic_ancestors(
        k_rs, flat_lw, cfg_.n_particles), (0, P_cap - cfg_.n_particles))
    parent = (anc % P_cap).astype(jnp.int32)
    hyp = (anc // P_cap).astype(jnp.int32)
    gathered = resample_ops.gather_particles(
        {"pose": s.particles.pose, "gm": s.gm, "cand": s.cand}, parent)
    da_sel = das[parent, hyp]
    gm2, z_used, _, n_in_fov = filt._apply_hypothesis(
        gathered["pose"], gathered["gm"], z, z_mask, da_sel,
        jnp.take(table, parent, axis=0), jnp.take(lm_idx, parent, axis=0),
        jnp.take(row_valid, parent, axis=0),
        jnp.take(pd_rank, parent, axis=0), jnp.zeros((P_cap,)))
    gm2, cand = filt._candidates(gathered["pose"], gm2, gathered["cand"],
                                 z, z_mask, z_used, n_in_fov)
    return s.replace(gm=gm2, cand=cand,
                     particles=s.particles.replace(key=key))


scan_time("post-murty (score+gather+apply+cand)", post_murty_phase, state,
          n=10)


def apply_only(s):
    gm2, z_used, lw, n_in_fov = filt._apply_hypothesis(
        s.particles.pose, s.gm, z, z_mask, das[:, 0, :], table, lm_idx,
        row_valid, pd_rank, jnp.zeros((s.particles.pose.shape[0],)))
    return s.replace(gm=gm2)


scan_time("  _apply_hypothesis only", apply_only, state, n=10)


def cand_only(s):
    z_used = jnp.zeros((s.particles.pose.shape[0], z.shape[0]), bool)
    gm2, cand = filt._candidates(s.particles.pose, s.gm, s.cand, z, z_mask,
                                 z_used, jnp.zeros_like(s.n_in_fov))
    return s.replace(gm=gm2, cand=cand)


scan_time("  _candidates only", cand_only, state, n=10)

# ---- murty internals: hungarian at various batch widths
for B in (600, 600 * 8, 600 * 31):
    tab_b = jnp.tile(table[:600], (max(1, B // 600), 1, 1))[:B]

    def hb(tb):
        sol, tot = jax.vmap(hungarian)(tb)
        return tb + 1e-12 * (jnp.sum(sol, axis=1, dtype=tb.dtype)
                             + tot)[:, None, None]

    scan_time(f"  hungarian batch={B}", hb, tab_b, n=2)
