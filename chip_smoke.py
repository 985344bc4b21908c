"""Smoke test of the main path on one NVIDIA GPU (four with ``--multi``).

Run from the repository root::

    python chip_smoke.py            # one card, every phase below
    python chip_smoke.py --multi    # four cards: the particle-sharded path

Default phases, in order (any failure exits non-zero; none is caught):

* device   — JAX platform, device kind and count, and the card's name and
             power limit from nvidia-smi; exits non-zero unless JAX's
             backend is a GPU.
* ops      — each op compiled for the card against its float64 NumPy/SciPy
             oracle (rfs_slam_tpu.oracles, the same the CPU tests use), at
             bench widths P=200, Zc=40, M=128 (D=3 where an op has a D=3
             path).  Each tolerance and precision is printed beside its
             result.
* step     — one RB-PHD step and one MH-FastSLAM step from a fixed mid-run
             state and key, on the card and on the host CPU: map planes and
             log-weights before resampling within stated tolerances;
             ancestors equal wherever no cumulative weight lies within that
             tolerance of a resampling threshold.
* rbphd    — the rbphdslam2dsim app through its main() with the in-repo
             config at full reference scale (3000 steps x 200 particles x 50
             landmarks), then the bench's compiled scan over the committed
             C++ dump (native/bl_dump); both finite with median pose error
             <= 0.25 m (a divergence guard: see DIVERGENCE_GUARD_M).
* fastslam — the fastslam2dsim app: FastSLAM 1.0 for 1000 steps and
             MH-FastSLAM (H=3) for 300 steps, full widths, same guards.

``--multi`` runs only the particle-sharded path on four cards: RB-PHD with
P=800 for 300 steps on a 4-card particle mesh, and one step on the 2x2
particles x map mesh, each against the same seed on one card.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time

from rfs_slam_tpu.utils import cache

cache.enable()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import bench  # noqa: E402
from rfs_slam_tpu import oracles  # noqa: E402
from rfs_slam_tpu.core import planar  # noqa: E402
from rfs_slam_tpu.core.state import GMState  # noqa: E402
from rfs_slam_tpu.ops import assignment, gm as gm_ops  # noqa: E402
from rfs_slam_tpu.ops.ekf import InnovationGates, correct_all  # noqa: E402
from rfs_slam_tpu.ops.rfs_likelihood import rfs_log_likelihood  # noqa: E402
from rfs_slam_tpu.utils import device  # noqa: E402

P, ZC, M = 200, 40, 128          # bench widths
HIGHEST = "f32, precision=HIGHEST"

# Median best-particle pose error above which a run has diverged.  The
# bench's identical-data anchor (0.12 m) was fitted to one trajectory
# computed with bfloat16-rounded map inserts; in exact float32 this replay
# reads 0.1673 m on the H100 (0.125-0.479 m over 8 init seeds), 0.2458 m on
# the CPU, and 0.0426 m on the CPU with the inserts rounded to bfloat16 —
# one chaotic draw, not an accuracy level (PERF.md, Findings).
DIVERGENCE_GUARD_M = 0.25


class CheckFailed(AssertionError):
    pass


@contextlib.contextmanager
def phase(name):
    print(f"== phase {name}", flush=True)
    t0 = time.perf_counter()
    yield
    print(f"== phase {name}: ok ({time.perf_counter() - t0:.1f} s)",
          flush=True)


def check(name, got, want, rtol=0.0, atol=0.0, precision=HIGHEST,
          mask=None):
    """Compare arrays; print the tolerance and precision beside the result.
    rtol == atol == 0 demands bit equality."""
    got = np.asarray(got)
    want = np.asarray(want)
    if mask is not None:
        got, want = got[mask], want[mask]
    if got.shape != want.shape:
        raise CheckFailed(f"{name}: shape {got.shape} != {want.shape}")
    if rtol == 0.0 and atol == 0.0:
        bad = int(np.sum(got != want))
        tol = "bit-exact"
        err = bad
    else:
        g = got.astype(np.float64)
        w = want.astype(np.float64)
        excess = np.abs(g - w) - (atol + rtol * np.abs(w))
        bad = int(np.sum(~(excess <= 0)))
        tol = f"rtol={rtol:g} atol={atol:g}"
        with np.errstate(invalid="ignore", divide="ignore"):
            err = float(np.nanmax(np.abs(g - w) / np.maximum(np.abs(w),
                                                               1e-30),
                                  initial=0.0))
    print(f"  {name:<34s} [{precision}; {tol}] n={got.size} "
          f"{'max rel err' if tol != 'bit-exact' else 'mismatches'}="
          f"{err:.3g} -> {'ok' if bad == 0 else f'FAIL ({bad} off)'}",
          flush=True)
    if bad:
        raise CheckFailed(name)


# ------------------------------------------------------------------- ops
def ops_lanes(rng, P=P, M=M, K=48):
    """put_lane / take_lane / replace_weakest vs plain indexing."""
    a = jnp.asarray(rng.normal(size=(9, P, M)), jnp.float32)
    idx = jnp.asarray(rng.integers(0, M, size=(P, K)), jnp.int32)
    got = jax.jit(lambda a, i: planar.take_lane(
        a, planar.onehot(i, M, a.dtype)[None]))(a, idx)
    want = jax.jit(lambda a, i: jnp.take_along_axis(
        a, jnp.broadcast_to(i, (9, P, K)), axis=2))(a, idx)
    check("take_lane", got, want)

    slots = np.argsort(rng.uniform(size=(P, M)), axis=1)[:, :K]
    idx = jnp.asarray(slots, jnp.int32)
    valid = jnp.asarray(rng.uniform(size=(P, K)) < 0.8)
    src = jnp.asarray(rng.normal(size=(P, K)) * 1e3, jnp.float32)
    dst = jnp.asarray(rng.normal(size=(P, M)), jnp.float32)
    got = jax.jit(planar.put_lane)(dst, idx, src, valid)
    rows = jnp.arange(P)[:, None]
    want = jax.jit(lambda d, i, s, v: d.at[rows, jnp.where(v, i, M)].set(
        s, mode="drop"))(dst, idx, src, valid)
    check("put_lane", got, want)

    gm, new = random_gm_and_births(rng, P, M, K)
    out = jax.jit(gm_ops.replace_weakest)(gm, *new)
    ref = oracles.replace_weakest(*map(np.asarray, (
        gm.mean, gm.cov, gm.w, gm.w_prev, gm.alive)),
        *map(np.asarray, new))
    for name, g, w in zip(("mean", "cov", "w", "w_prev", "alive"),
                          (out.mean, out.cov, out.w, out.w_prev, out.alive),
                          ref):
        check(f"replace_weakest.{name}", g, w)


def random_gm_and_births(rng, P, M, K, D=2):
    w = rng.uniform(0.01, 1.0, size=(P, M)).astype(np.float32)
    alive = rng.uniform(size=(P, M)) < 0.5
    gm = GMState(
        mean=jnp.asarray(rng.normal(size=(D, P, M)), jnp.float32),
        cov=jnp.asarray(rng.uniform(0.1, 1.0, size=(planar.tri_size(D), P,
                                                    M)), jnp.float32),
        w=jnp.asarray(w), w_prev=jnp.asarray(w * 0.5),
        alive=jnp.asarray(alive))
    new = (jnp.asarray(rng.normal(size=(D, P, K)), jnp.float32),
           jnp.asarray(rng.uniform(0.1, 1.0, size=(planar.tri_size(D), P,
                                                   K)), jnp.float32),
           jnp.asarray(rng.uniform(0.01, 1.0, size=(P, K)), jnp.float32),
           jnp.asarray(rng.uniform(size=(P, K)) < 0.7))
    return gm, new


def ops_ekf(rng, P=P, Zc=ZC, M=M):
    """ops/ekf.correct_all vs the float64 range-bearing EKF."""
    R = np.diag([5e-3, 5e-4])
    from rfs_slam_tpu.models.measurement import RangeBearing
    meas = RangeBearing(R=R.astype(np.float32), pd_const=0.99, clutter=1e-4,
                        r_max=2.5, r_min=0.5, r_buf=0.05)
    gates = InnovationGates.range_bearing(range_t=1.0, bearing_t=0.2)
    pose = rng.uniform([-1, -1, -np.pi], [1, 1, np.pi], size=(P, 3))
    rng_r = rng.uniform(0.6, 2.4, size=(P, M))
    ang = rng.uniform(-np.pi, np.pi, size=(P, M))
    lm = np.stack([pose[:, None, 0] + rng_r * np.cos(ang),
                   pose[:, None, 1] + rng_r * np.sin(ang)], -1)   # [P, M, 2]
    A = rng.normal(size=(P, M, 2, 2)) * 0.03
    C = A @ np.swapaxes(A, -1, -2) + 2e-3 * np.eye(2)
    src = lm[0, :Zc]
    z = np.stack([np.hypot(src[:, 0] - pose[0, 0], src[:, 1] - pose[0, 1]),
                  oracles.wrap(np.arctan2(src[:, 1] - pose[0, 1],
                                          src[:, 0] - pose[0, 0])
                               - pose[0, 2])], -1)
    z = z + rng.normal(size=z.shape) * [0.05, 0.02]
    pose, lm, C, z = (x.astype(np.float32) for x in (pose, lm, C, z))
    out = jax.jit(lambda *a: correct_all(meas, gates, *a))(
        jnp.asarray(pose), planar.pack_vec(jnp.asarray(lm)),
        planar.pack_sym(jnp.asarray(C)), jnp.asarray(z))
    ref = oracles.ekf_correct(pose[:, None, None, :], lm[:, None, :, :],
                              C[:, None, :, :, :], z[None, :, None, :], R)
    K_ref = np.stack([ref.K[:, 0, :, d, e] for d in range(2)
                      for e in range(2)])
    Kmax = np.abs(K_ref).max()
    check("ekf.K", out.K, K_ref, rtol=1e-4, atol=1e-6 * Kmax)
    cov_ref = planar.pack_sym(jnp.asarray(ref.cov[:, 0]))
    check("ekf.cov_upd", out.cov_upd, cov_ref, rtol=1e-4,
          atol=1e-6 * float(np.abs(C).max()))
    # a bearing innovation within 1e-4 of +-pi may wrap to either side
    unwrapped = np.abs(np.abs(ref.innov[..., 1]) - np.pi) > 1e-4
    check("ekf.md2", out.md2, ref.md2, rtol=1e-4, atol=1e-4, mask=unwrapped)
    ze = np.array(out.z_exp)
    ze_ref = np.moveaxis(ref.z_exp[:, 0], -1, 0)
    ze[1] = ze_ref[1] + oracles.wrap(ze[1] - ze_ref[1])  # compare mod 2 pi
    check("ekf.z_exp", ze, ze_ref, rtol=1e-5, atol=1e-6)
    # likelihood where the gates pass in float64, away from the gate edge
    # and from exp underflow
    inn = ref.innov
    valid = ((np.abs(inn[..., 0]) <= 1.0 - 1e-4)
             & (np.abs(inn[..., 1]) <= 0.2 - 1e-4) & (ref.md2 <= 50.0))
    check("ekf.likelihood", out.likelihood, ref.lik, rtol=1e-3,
          mask=valid)


def random_gm_dense(rng, P, M, D, n_alive):
    mean = rng.uniform(-3, 3, size=(P, M, D))
    A = rng.normal(size=(P, M, D, D)) * 0.3
    cov = A @ np.swapaxes(A, -1, -2) + 0.2 * np.eye(D)
    w = rng.uniform(0.05, 1.0, size=(P, M))
    alive = np.zeros((P, M), bool)
    for p in range(P):
        alive[p, rng.choice(M, n_alive, replace=False)] = True
    return tuple(x.astype(np.float32) if x.dtype != bool else x
                 for x in (mean, cov, w, 0.5 * w, alive))


def ops_merge(rng, D, P=P, M=M, n_alive=60, threshold=1.5, f=1.5):
    mean, cov, w, w_prev, alive = random_gm_dense(rng, P, M, D, n_alive)
    gm = GMState.from_dense(jnp.asarray(mean), jnp.asarray(cov),
                            jnp.asarray(w), jnp.asarray(w_prev),
                            jnp.asarray(alive))
    out = jax.jit(lambda g: gm_ops.merge(g, threshold, f))(gm)
    r_mean, r_cov, r_w, r_wp, r_alive = oracles.merge(
        mean, cov, w, w_prev, alive, threshold, f)
    n_merged = int(alive.sum() - r_alive.sum())
    print(f"  merge D={D}: {int(alive.sum())} alive -> "
          f"{int(r_alive.sum())} ({n_merged} merged)")
    check(f"merge{D}d.alive", out.alive, r_alive)
    a = r_alive
    check(f"merge{D}d.w", np.asarray(out.w)[a], r_w[a], rtol=1e-5,
          atol=1e-7)
    check(f"merge{D}d.w_prev", np.asarray(out.w_prev)[a], r_wp[a],
          rtol=1e-5, atol=1e-7)
    check(f"merge{D}d.mean", np.asarray(out.mean_dense)[a], r_mean[a],
          rtol=1e-4, atol=1e-5)
    check(f"merge{D}d.cov", np.asarray(out.cov_dense)[a], r_cov[a],
          rtol=1e-3, atol=1e-5)


def ops_rfs_likelihood(rng, P=P, E=15, Z=ZC, z_dp_max=10):
    """Sparse gated tables: 6 supported eval points over <= 10 columns."""
    L = np.zeros((P, E, Z))
    for p in range(P):
        cols = rng.choice(Z, z_dp_max, replace=False)
        for r in rng.choice(E, 6, replace=False):
            for c in rng.choice(cols, rng.integers(1, 4), replace=False):
                L[p, r, c] = rng.uniform(0.1, 5.0)
    pd = rng.uniform(0.3, 0.95, size=(P, E))
    L = L * pd[:, :, None]
    clutter = rng.uniform(0.01, 0.5, size=(P, Z))
    lci = 0.7
    L, pd, clutter = (x.astype(np.float32) for x in (L, pd, clutter))
    got = jax.jit(lambda L, pd, c: rfs_log_likelihood(
        L, pd, jnp.ones((P, E), bool), c, jnp.ones((Z,), bool), lci,
        z_dp_max=z_dp_max))(L, pd, clutter)
    want = [oracles.rfs_log_likelihood(L[p], pd[p], clutter[p], lci)
            for p in range(P)]
    check("rfs_log_likelihood", got, want, rtol=1e-3, atol=3e-4,
          precision="f32")


def ops_assignment(rng, P=P, n=32, k=3):
    from scipy.optimize import linear_sum_assignment

    cost = (rng.normal(size=(P, n, n)) * 3).astype(np.float32)
    _, totals = jax.jit(assignment.hungarian_batched)(jnp.asarray(cost))
    want = [cost[p][linear_sum_assignment(cost[p], maximize=True)].sum()
            for p in range(P)]
    check("hungarian", totals, want, rtol=1e-4, precision="f32")

    _, scores, valid = jax.jit(jax.vmap(
        lambda c: assignment.murty(c, k)))(jnp.asarray(cost))
    check("murty.valid", valid, np.ones((P, k), bool))
    want = np.stack([oracles.murty_scores(cost[p], k) for p in range(P)])
    check("murty.scores", scores, want, rtol=1e-4, precision="f32")

    # MH-FastSLAM settings: 3 hypotheses, child cap 6, window 3.0, over the
    # P_cap = 3 * P lanes; a lane budget covering every ambiguous lane must
    # reproduce the plain vmapped murty exactly
    lanes = 3 * P
    tables = np.full((lanes, n, n), -10.0, np.float32)
    n_ms = rng.integers(0, min(16, n), size=lanes).astype(np.int32)
    n_z = min(12, n - 1)
    for p in range(lanes):
        tables[p, :n_ms[p], :n_z] = rng.normal(size=(n_ms[p], n_z)) * 2
    tables, n_ms = jnp.asarray(tables), jnp.asarray(n_ms)
    kw = dict(real_cols=n_z, child_cap=6, prune_window=3.0)
    n_amb = int(jnp.sum(jax.jit(
        lambda t, r: assignment.ambiguous_lanes(t, r, n_z, 3.0))(
            tables, n_ms)))
    budget = min(max(n_amb, 1), lanes - 1)
    print(f"  murty_gated: {n_amb} of {lanes} lanes ambiguous, "
          f"budget {budget}")
    das, sc, va, overflow = jax.jit(lambda t, r: assignment.murty_gated(
        t, k, r, budget=budget, return_overflow=True, **kw))(tables, n_ms)
    if int(overflow):
        raise CheckFailed(f"murty_gated overflow {int(overflow)}")
    plain = jax.jit(jax.vmap(lambda t, r: assignment.murty(
        t, k, real_rows=r, **kw)))(tables, n_ms)
    check("murty_gated.das", das, plain[0])
    check("murty_gated.scores", sc, plain[1], precision="f32")
    check("murty_gated.valid", va, plain[2])


# ------------------------------------------------------------------ step
def safe_comb(log_w, key, n):
    """Mask of systematic-resampling comb points that no cumulative weight
    lies within STEP_TOL of (ops/resample.systematic_ancestors)."""
    lw = np.asarray(log_w, np.float64)
    w = np.exp(lw - np.logaddexp.reduce(lw[np.isfinite(lw)]))
    cum = np.cumsum(np.where(np.isfinite(lw), w, 0.0))
    u0 = float(jax.random.uniform(key, (), dtype=jnp.float32))
    pts = (u0 + np.arange(n)) / n
    return np.abs(cum[None, :] - pts[:, None]).min(axis=1) > STEP_TOL


STEP_TOL = 1e-4


def compare_gm(tag, a, b, rows=None):
    """Compare two maps particle by particle as sets of Gaussians: equal
    alive counts, then weights, means and covariances with the slots of
    each ordered by mean x (Gaussians whose float32 weights tie may sit in
    each other's slots)."""
    rows = np.ones(a.w.shape[0], bool) if rows is None else rows
    idx = np.nonzero(rows)[0]
    check(f"{tag}.gm.alive count", np.asarray(a.alive)[idx].sum(axis=1),
          np.asarray(b.alive)[idx].sum(axis=1), precision="int")

    def as_sets(g):
        al, mx = np.asarray(g.alive), np.asarray(g.mean)[0]
        out = {"w": [], "mean": [], "cov": []}
        for p in idx:
            o = np.nonzero(al[p])[0]
            o = o[np.argsort(mx[p, o], kind="stable")]
            out["w"].append(np.asarray(g.w)[p, o])
            out["mean"].append(np.asarray(g.mean)[:, p, o].T.ravel())
            out["cov"].append(np.asarray(g.cov)[:, p, o].T.ravel())
        return {k: np.concatenate(v) if v else np.zeros(0)
                for k, v in out.items()}

    sa, sb = as_sets(a), as_sets(b)
    check(f"{tag}.gm.w", sa["w"], sb["w"], rtol=1e-4, atol=1e-6)
    for name in ("mean", "cov"):
        check(f"{tag}.gm.{name}", sa[name], sb[name], rtol=1e-4, atol=1e-5)


def on(dev, tree):
    return jax.device_put(jax.tree_util.tree_map(np.asarray, tree), dev)


def rbphd_parts(filt, dt):
    """One RB-PHD step split at resampling: returns ``(gm_full, log_w,
    parent, k_rs)`` — the merged and pruned map and the log-weights before
    resampling, the ancestors, and the resampling key."""

    def parts(state, inp):
        odo, z, z_mask, _, _ = inp
        state = filt.predict(state, odo, dt)
        nz = jnp.sum(z_mask)
        gm_full, log_w, unused, n_in_fov, clutter_z = filt._map_update(
            state, z, z_mask, filt.meas)
        log_w = filt._importance_weights(
            log_w, state.particles.pose, gm_full, z, z_mask, clutter_z, nz,
            filt.meas)
        gm_full = gm_ops.prune(gm_ops.merge(
            gm_full, filt.cfg.merge_threshold, filt.cfg.merge_inflation),
            filt.cfg.prune_threshold)
        out = filt._resample_phase(state, gm_full, log_w, unused, n_in_fov,
                                   z, z_mask, nz)
        _, k_rs = jax.random.split(state.particles.key)
        return gm_full, log_w, out.particles.parent, k_rs

    return parts


def compare_parts(tag, got, ref):
    """Compare two ``rbphd_parts`` results (``ref`` decides the comb)."""
    (g_gm, g_lw, g_par, _), (c_gm, c_lw, c_par, k_rs) = got, ref
    compare_gm(tag, g_gm, c_gm)
    check(f"{tag}.log_w (pre-resample)", g_lw, c_lw, rtol=1e-4, atol=1e-3)
    safe = safe_comb(c_lw, k_rs, len(c_lw))
    print(f"  {tag} ancestors: {int(safe.sum())}/{len(safe)} comb points "
          f"clear of a cumulative weight by {STEP_TOL:g}")
    check(f"{tag}.ancestors", g_par[safe], c_par[safe], precision="int")


def step_rbphd(gpu, cpu, warm=200, n_particles=P):
    sim_cfg, data, filt = bench.build(n_particles)
    inputs = bench.scan_inputs(data.odometry, data.z, data.z_mask,
                               data.gt_pose)
    head = jax.tree_util.tree_map(lambda a: a[:warm], inputs)
    state = filt.init_state(jax.random.PRNGKey(0), jnp.zeros(3))
    state, _ = jax.jit(bench.make_run(filt, sim_cfg.dt))(state, head)
    step_in = jax.tree_util.tree_map(lambda a: a[warm], inputs)
    parts = jax.jit(rbphd_parts(filt, sim_cfg.dt))
    res = [jax.tree_util.tree_map(np.asarray, parts(on(dev, state),
                                                     on(dev, step_in)))
           for dev in (gpu, cpu)]
    compare_parts("rbphd", *res)


def step_mh(gpu, cpu, warm=100, n_particles=None):
    from rfs_slam_tpu.apps import fastslam2dsim as app
    from rfs_slam_tpu.io import sim2d
    from rfs_slam_tpu.io.xmlconfig import XmlConfig, default_cfg, load_sim2d

    cfg = XmlConfig(default_cfg("mhfastslam2dSim.xml"))
    sim_cfg = dataclasses.replace(load_sim2d(cfg), timesteps=warm + 1)
    data = sim2d.generate(sim_cfg, traj_seed=0, noise_seed=0)
    filt = app.build_filter_from_xml(cfg, sim_cfg, n_particles=n_particles,
                                     z_capacity=max(data.z.shape[1], 4))
    state, _, _ = app.run(
        filt, dataclasses.replace(sim_cfg, timesteps=warm),
        dataclasses.replace(data, odometry=data.odometry[:warm],
                            z=data.z[:warm], z_mask=data.z_mask[:warm],
                            gt_pose=data.gt_pose[:warm]))
    odo, z, zm = (jnp.asarray(a[warm], jnp.float32 if a.dtype != bool
                              else bool)
                  for a in (data.odometry, data.z, data.z_mask))

    def parts(state, odo, z, zm):
        state = filt.predict(state, odo, sim_cfg.dt)
        table, lm_idx, row_valid, pd_rank, _, gate_tab = filt._da_table(
            state.particles.pose, state.gm, z, zm)
        das, flat_lw, _ = filt._mh_hypothesis_weights(
            state, z, zm, table, row_valid, gate_tab)
        out = filt.update(state, z, zm)
        _, k_rs = jax.random.split(state.particles.key)
        return table, das, flat_lw, out, k_rs

    res = {}
    for tag, dev in (("gpu", gpu), ("cpu", cpu)):
        res[tag] = jax.tree_util.tree_map(
            np.asarray, jax.jit(parts)(*on(dev, (state, odo, z, zm))))
    g, c = res["gpu"], res["cpu"]
    check("mh.da_table", g[0], c[0], rtol=1e-4, atol=1e-4)
    check("mh.hypotheses", g[1], c[1], precision="int")
    fin = np.isfinite(c[2])
    check("mh.log_w finite", np.isfinite(g[2]), fin, precision="bool")
    check("mh.log_w (pre-resample)", g[2][fin], c[2][fin], rtol=1e-4,
          atol=1e-3)
    n = filt.cfg.n_particles
    safe = np.zeros(filt.p_cap, bool)
    safe[:n] = safe_comb(c[2], c[4], n)
    g_out, c_out = g[3], c[3]
    print(f"  mh ancestors: {int(safe.sum())}/{n} comb points clear of a "
          f"cumulative weight by {STEP_TOL:g}")
    check("mh.parent", g_out.particles.parent[safe],
          c_out.particles.parent[safe], precision="int")
    compare_gm("mh", g_out.gm, c_out.gm, rows=safe)


# ------------------------------------------------------------- app runs
def run_rbphd(dev):
    from rfs_slam_tpu.apps import rbphdslam2dsim

    s = rbphdslam2dsim.main([])
    print(f"  rbphdslam2dsim: {s.steps} steps, {s.steps / s.wall_s:.1f} "
          f"timesteps/s incl. compile, median pose err "
          f"{s.median_pose_err_m:.4f} m, finite={s.finite} "
          f"[{dev['nvidia_smi']}]")
    guard(s, "rbphdslam2dsim")

    sim_cfg, _, filt = bench.build()
    id_gt, id_inputs = bench.load_identical_data()
    state = filt.init_state(jax.random.PRNGKey(0), jnp.zeros(3))
    compiled = jax.jit(bench.make_run(filt, sim_cfg.dt)).lower(
        state, id_inputs).compile()
    bench.timed(compiled, state, id_inputs)
    secs, out = bench.timed(compiled, state, id_inputs)
    err = bench.pose_err(out[1], id_gt)
    anchor = bench.IDENTICAL_DATA_ANCHOR_M
    print(f"  bench identical-data replay: median pose err {err:.4f} m "
          f"(divergence guard {DIVERGENCE_GUARD_M} m; bench anchor {anchor} "
          f"m {'met' if err <= anchor else 'NOT met'}), "
          f"{(bench.T - 1) / secs:.1f} timesteps/s steady state "
          f"[{dev['nvidia_smi']}]")
    if not err <= DIVERGENCE_GUARD_M:
        raise CheckFailed("identical-data pose error")


def guard(s, name, max_err=DIVERGENCE_GUARD_M):
    if not s.finite:
        raise CheckFailed(f"{name}: non-finite output")
    if not s.median_pose_err_m <= max_err:
        raise CheckFailed(f"{name}: median pose error "
                          f"{s.median_pose_err_m:.4f} m > {max_err} m")


def run_fastslam(dev):
    from rfs_slam_tpu.apps import fastslam2dsim
    from rfs_slam_tpu.io.xmlconfig import default_cfg

    for cfg, steps in (("fastslam2dSim.xml", 1000),
                       ("mhfastslam2dSim.xml", 300)):
        print(f"  {cfg}: cut to {steps} of 3000 steps (widths unchanged)")
        s = fastslam2dsim.main(["--cfg", default_cfg(cfg),
                                "--steps", str(steps)])
        print(f"  {cfg}: {s.steps} steps, {s.steps / s.wall_s:.1f} "
              f"timesteps/s incl. compile, median pose err "
              f"{s.median_pose_err_m:.4f} m, finite={s.finite} "
              f"[{dev['nvidia_smi']}]")
        guard(s, cfg)


# ---------------------------------------------------------------- multi
def run_multi(n_dev=4, n_particles=800, steps=300, devs=None):
    from rfs_slam_tpu.parallel import mesh as mesh_lib

    devs = (devs or jax.devices())[:n_dev]
    if len(devs) < n_dev:
        raise CheckFailed(f"--multi needs {n_dev} devices, have {len(devs)}")
    sim_cfg, data, filt = bench.build(n_particles)
    inputs = jax.tree_util.tree_map(
        lambda a: a[:steps],
        bench.scan_inputs(data.odometry, data.z, data.z_mask, data.gt_pose))
    run = bench.make_run(filt, sim_cfg.dt)
    state0 = filt.init_state(jax.random.PRNGKey(0), jnp.zeros(3))

    t0 = time.perf_counter()
    one_state, one_best = jax.block_until_ready(jax.jit(run)(
        on(devs[0], state0), on(devs[0], inputs)))
    t_one = time.perf_counter() - t0

    mesh = mesh_lib.make_mesh(n_dev, devices=devs)
    sh = mesh_lib.state_shardings(state0, mesh, n_particles)
    repl = mesh_lib.replicated(mesh)
    t0 = time.perf_counter()
    sh_state, sh_best = jax.block_until_ready(jax.jit(
        run, in_shardings=(sh, repl), out_shardings=(sh, repl))(
            jax.device_put(state0, sh), jax.device_put(inputs, repl)))
    t_sh = time.perf_counter() - t0
    e1 = bench.pose_err(one_best, data.gt_pose[:steps + 1])
    e4 = bench.pose_err(sh_best, data.gt_pose[:steps + 1])
    diff = np.linalg.norm(np.asarray(one_best)[:, :2]
                          - np.asarray(sh_best)[:, :2], axis=1)
    print(f"  P={n_particles}, {steps} steps: one card {t_one:.1f} s, "
          f"{n_dev} cards {t_sh:.1f} s (both incl. compile); median pose "
          f"err one card {e1:.4f} m, sharded {e4:.4f} m; best-pose "
          f"distance between the runs: median {np.median(diff):.3g} m, "
          f"max {diff.max():.3g} m")
    for name, e in (("one card", e1), ("sharded", e4)):
        if not (np.isfinite(e) and e <= DIVERGENCE_GUARD_M):
            raise CheckFailed(f"multi {name}: median pose err {e}")

    # one step from the sharded run's final state, split at resampling, on
    # the particle mesh and on the 2x2 particles x map mesh, each against
    # the same step on one card
    step_in = jax.tree_util.tree_map(lambda a: a[-1], inputs)
    host_state = jax.tree_util.tree_map(np.asarray, sh_state)
    parts = rbphd_parts(filt, sim_cfg.dt)
    ref = jax.tree_util.tree_map(np.asarray, jax.jit(parts)(
        on(devs[0], host_state), on(devs[0], step_in)))
    mesh2 = mesh_lib.make_mesh_2d(2, n_dev // 2, devices=devs)
    for tag, m, shard in (
            ("particle-mesh", mesh,
             mesh_lib.state_shardings(host_state, mesh, n_particles)),
            ("2x2-mesh", mesh2, mesh_lib.state_shardings_2d(
                host_state, mesh2, n_particles, bench.MAP_CAPACITY))):
        r = jax.sharding.NamedSharding(m, jax.sharding.PartitionSpec())
        got = jax.tree_util.tree_map(np.asarray, jax.jit(
            parts, in_shardings=(shard, r))(
                jax.device_put(host_state, shard),
                jax.device_put(step_in, r)))
        compare_parts(tag, got, ref)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the 4-card particle-sharded path")
    args = ap.parse_args(argv)

    with phase("device"):
        dev = device.require_gpu("chip_smoke")
        print(f"  backend {jax.default_backend()}, {dev['kind']} x "
              f"{dev['count']}")
        print(f"  nvidia-smi: {dev['nvidia_smi']}")
        print(f"  JAX {jax.__version__}")
    if args.multi:
        with phase("multi"):
            run_multi()
        count = 4
    else:
        rng = np.random.default_rng(0)
        with phase("ops"):
            ops_lanes(rng)
            ops_ekf(rng)
            ops_merge(rng, D=2)
            ops_merge(rng, D=3)
            ops_rfs_likelihood(rng)
            ops_assignment(rng)
        gpu, cpu = jax.devices()[0], jax.devices("cpu")[0]
        with phase("step"):
            step_rbphd(gpu, cpu)
            step_mh(gpu, cpu)
        with phase("rbphd"):
            run_rbphd(dev)
        with phase("fastslam"):
            run_fastslam(dev)
        count = 1
    print(f"{dev['nvidia_smi'].splitlines()[0]}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"], "count": count}}))


if __name__ == "__main__":
    main()
