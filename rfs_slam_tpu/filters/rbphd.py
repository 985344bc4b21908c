"""RB-PHD SLAM filter — batched, fixed-shape, one jitted function per phase.

Re-implements the semantics of the reference ``RBPHDFilter``
(reference: RBPHDFilter.hpp:72-1237) as dense masked array programs over the
whole particle set:

* ``predict``  = addBirthGaussians + particle propagation + landmark
  covariance growth (RBPHDFilter.hpp:416-442);
* ``update``   = batched EKF map update with the nM x nZ weight table
  (RBPHDFilter.hpp:543-725), importance weighting with the exact RFS
  measurement likelihood (RBPHDFilter.hpp:728-997, replaced by the
  subset-sum DP of :mod:`rfs_slam_tpu.ops.rfs_likelihood`), GM merge/prune,
  and ESS-gated systematic resampling (RBPHDFilter.hpp:500-539).

All map state is plane-major (:mod:`rfs_slam_tpu.core.planar`): means are
``[D, P, M]`` and covariances packed ``[T, P, M]``, with the landmark axis M
innermost, so every phase is a fused elementwise program.  The weight table
is ``[P, Z, M]``.

Known, documented deviations from the reference (all order-dependence or
approximation-class; parity is statistical — see SURVEY.md section 7):

* merge is parallel-pass greedy instead of sequential greedy;
* birth-candidate matching assigns each unused measurement to its best
  candidate in one pass instead of sequentially mutating the list;
* the RFS likelihood is EXACT for up to ``z_dp_max`` supported measurement
  columns (the reference truncates to Murty's 200 best assignments);
* angle differences are wrapped where the reference uses raw differences
  (raw differences mis-evaluate near +-pi).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

from rfs_slam_tpu.core import gaussian, planar, struct
from rfs_slam_tpu.core.state import BirthCandidates, GMState, ParticleState
from rfs_slam_tpu.ops import gm as gm_ops
from rfs_slam_tpu.ops import resample as resample_ops
from rfs_slam_tpu.ops.ekf import InnovationGates, correct_all, correct_single
from rfs_slam_tpu.ops.rfs_likelihood import rfs_log_likelihood

LOG_TINY = -80.0  # log-domain stand-in for denorm_min (RBPHDFilter.hpp:743)


@dataclasses.dataclass(frozen=True)
class RBPHDConfig:
    """Static configuration (shapes + thresholds).

    Mirrors ``RBPHDFilter::Config`` (reference: RBPHDFilter.hpp:90-146) plus
    the capacity parameters that replace dynamic allocation.
    """

    n_particles: int = 200
    map_capacity: int = 256          # padded GM size per particle
    z_capacity: int = 16             # padded measurement-set size
    new_capacity: int = 64           # cap on new Gaussians kept per update
    new_per_z: int = 8               # per-measurement new-Gaussian cap (see
                                     # _map_update's hierarchical selection).
                                     # Default matches the bench-of-record
                                     # configuration (bench.py) so sim apps
                                     # built without overrides truncate birth
                                     # candidates identically to the bench.
    birth_capacity: int = 16         # birth-candidate list capacity
    eval_capacity: int = 15          # importanceWeightingEvalPointCount_
    z_dp_max: int = 10               # exact-DP column budget for RFS likelihood

    birth_gaussian_weight: float = 0.25
    birth_count_threshold: int = 1   # birthGaussianMeasurementCountThreshold_
    birth_check_threshold: int = 1
    birth_support_dist: float = 1.0
    birth_current_meas_count_threshold: int = 1
    new_gaussian_md_threshold: float = 0.2  # newGaussianCreateInnovMDThreshold_
    eval_pt_min_weight: float = 0.75
    weighting_md_threshold: float = 3.0
    merge_threshold: float = 0.5
    merge_inflation: float = 1.5
    prune_threshold: float = 0.2
    min_updates_before_resample: int = 1
    min_measurements_before_resample: int = 1
    ess_threshold: float = 200.0
    use_cluster_process: bool = False


class RBPHDState(struct.PyTreeNode):
    particles: ParticleState
    gm: GMState
    birth: BirthCandidates
    last_z: jax.Array       # [Zc, DZ]   measurements of the previous update
    last_unused: jax.Array  # [P, Zc]    unused-measurement mask per particle
    n_in_fov: jax.Array     # [P] int32  landmarks in FOV at last update
    n_updates: jax.Array    # ()  int32  updates since last resample
    n_meas: jax.Array       # ()  int32  measurements since last resample


class RBPHDFilter:
    """Wires models + config into jit-ready pure step functions.

    Equivalent of instantiating
    ``RBPHDFilter<MotionModel, StaticProcessModel, MeasurementModel, KF>``
    (e.g. rbphdslam2dSim.cpp:444-492).
    """

    def __init__(self, motion, lmk_model, meas_model,
                 gates: InnovationGates, cfg: RBPHDConfig):
        self.motion = motion
        self.lmk = lmk_model
        self.meas = meas_model
        self.gates = gates
        self.cfg = cfg

    # ------------------------------------------------------------------ init
    def init_state(self, key: jax.Array, pose0, dz: int = 2,
                   d: int = 2, dtype=jnp.float32) -> RBPHDState:
        c = self.cfg
        return RBPHDState(
            particles=ParticleState.init(key, c.n_particles, pose0, dtype),
            gm=GMState.empty(c.n_particles, c.map_capacity, d, dtype),
            birth=BirthCandidates.empty(c.n_particles, c.birth_capacity, d, dtype),
            last_z=jnp.zeros((c.z_capacity, dz), dtype),
            last_unused=jnp.zeros((c.n_particles, c.z_capacity), bool),
            n_in_fov=jnp.zeros((c.n_particles,), jnp.int32),
            n_updates=jnp.zeros((), jnp.int32),
            n_meas=jnp.zeros((), jnp.int32),
        )

    # --------------------------------------------------------------- predict
    def predict(self, state: RBPHDState, u, dt,
                use_model_noise: bool = True, use_input_noise: bool = False,
                input_cov=None, birth_check: bool = True,
                meas=None, lmk=None) -> RBPHDState:
        """Reference: RBPHDFilter::predict (RBPHDFilter.hpp:416-442).

        ``meas``/``lmk`` override the wired models for this call (used by the
        Victoria Park app, whose measurement model carries per-scan state and
        whose landmark noise is per-dt — rbphdslam_VictoriaPark.cpp:508-517).
        """
        cfg = self.cfg
        meas = meas if meas is not None else self.meas
        lmk = lmk if lmk is not None else self.lmk
        key, k_prop, k_birth = jax.random.split(state.particles.key, 3)

        gm, birth = state.gm, state.birth
        if birth_check:
            gm, birth = self._add_birth_gaussians(state, k_birth, meas)

        # particle propagation (ParticleFilter::propagate via
        # ProcessModel::sample — ProcessModel.hpp:125-150)
        prop_keys = jax.random.split(k_prop, cfg.n_particles)
        pose = jax.vmap(
            lambda k, p: self.motion.sample(
                k, p, u, dt, use_model_noise, use_input_noise, input_cov
            )
        )(prop_keys, state.particles.pose)

        # landmark static step: cov += Q_lm (RBPHDFilter.hpp:433-439)
        _, cov = lmk.static_step_p(gm.mean, gm.cov, dt)
        gm = gm.replace(cov=jnp.where(gm.alive[None], cov, gm.cov))

        return state.replace(
            particles=state.particles.replace(pose=pose, key=key),
            gm=gm, birth=birth,
        )

    def _add_birth_gaussians(self, state: RBPHDState, key: jax.Array,
                             meas=None):
        """Reference: RBPHDFilter::addBirthGaussians (RBPHDFilter.hpp:1000-1084).

        Candidate matching/promotion as a masked state machine; with
        ``birth_count_threshold == 1`` (the 2-D sim configuration) every
        unused measurement becomes a birth Gaussian immediately, matching the
        reference exactly.
        """
        cfg = self.cfg
        meas = meas if meas is not None else self.meas
        pose = state.particles.pose                       # [P, 3]
        z = state.last_z                                  # [Zc, DZ]
        dz = z.shape[-1]
        unused = state.last_unused                        # [P, Zc]
        birth = state.birth
        P, Zc = unused.shape

        # landmark estimate for every unused measurement via the inverse model
        z_planes = [z[:, d][None, :] for d in range(dz)]  # broadcast [P, Zc]
        inv_mean, inv_cov = meas.inverse_p(pose[:, None, :], z_planes)

        few_in_fov = state.n_in_fov <= cfg.birth_current_meas_count_threshold

        if cfg.birth_count_threshold == 1:
            # immediate birth for every unused measurement
            new_alive = unused
            w_new = jnp.where(new_alive, cfg.birth_gaussian_weight, 0.0)
            gm = gm_ops.replace_weakest(state.gm, inv_mean, inv_cov, w_new, new_alive)
            return gm, birth

        # ---- candidate matching
        pred = meas.measure_p(pose[:, None, :], birth.mean, birth.cov)
        innov, _ = self.gates.innovation_p(
            [pred.z[d][:, :, None] for d in range(dz)],
            [z[:, d][None, None, :] for d in range(dz)],
        )                                                  # planes [P, C, Zc]
        S_inv = planar.inv_sym(pred.S, dz)
        md2 = planar.quad_sym(S_inv[:, :, :, None], innov, dz)   # [P, C, Zc]
        d2 = cfg.birth_support_dist**2
        match = (
            birth.alive[:, :, None] & unused[:, None, :] & (md2 <= d2)
        )                                                  # [P, C, Zc]

        # each unused z matches the first (lowest-index) matching candidate
        c_ids = jnp.arange(birth.capacity)
        first_c = jnp.min(
            jnp.where(match, c_ids[None, :, None], birth.capacity), axis=1
        )                                                  # [P, Zc]
        z_matched = first_c < birth.capacity
        claim = match & (c_ids[None, :, None] == first_c[:, None, :])

        # candidate correction with its best-matching measurement
        n_match = jnp.sum(claim, axis=2)                   # [P, C]
        best_z = jnp.argmin(jnp.where(claim, md2, jnp.inf), axis=2)
        z_best = jnp.stack([jnp.take(z[:, d], best_z) for d in range(dz)])
        m_upd, c_upd, _, _, _ = correct_single(
            meas, self.gates, pose[:, None, :], birth.mean, birth.cov, z_best
        )
        has_match = n_match > 0
        birth = birth.replace(
            mean=jnp.where(has_match[None], m_upd, birth.mean),
            cov=jnp.where(has_match[None], c_upd, birth.cov),
            n_support=birth.n_support + n_match,
        )

        # unmatched unused measurements become new candidates (or immediate
        # births when the map is sparse in the FOV)
        is_new = unused & ~z_matched
        immediate = is_new & few_in_fov[:, None]
        to_insert = is_new & ~immediate

        gm = gm_ops.replace_weakest(
            state.gm, inv_mean, inv_cov,
            jnp.where(immediate, cfg.birth_gaussian_weight, 0.0), immediate,
        )

        # scatter new candidates into free slots (rank-matching)
        free_order = jnp.argsort(birth.alive, axis=1)      # free slots first
        src_order = jnp.argsort(~to_insert, axis=1)        # new cands first
        K = min(birth.capacity, Zc)
        dest = free_order[:, :K]
        src = src_order[:, :K]
        n_free = jnp.sum(~birth.alive, axis=1, keepdims=True)
        n_new = jnp.sum(to_insert, axis=1, keepdims=True)
        ok = (jnp.arange(K)[None, :] < jnp.minimum(n_free, n_new))
        rows = jnp.arange(P)[:, None]

        def scat_pm(dst_arr, src_arr):
            """[P, C] dst <- [P, Zc] src at (rows, dest) — one-hot scatter
            (batched scatters serialize under vmap, planar.put_lane)."""
            src_v = jnp.take_along_axis(src_arr, src, axis=1)
            return planar.put_lane(dst_arr.astype(jnp.float32), dest,
                                   src_v.astype(jnp.float32),
                                   valid=ok).astype(dst_arr.dtype)

        def scat_pl(dst_arr, src_arr):
            """[X, P, C] dst <- [X, P, Zc] src at (:, rows, dest)."""
            src_v = jnp.take_along_axis(src_arr, src[None], axis=2)
            X = dst_arr.shape[0]
            return planar.put_lane(
                dst_arr, jnp.broadcast_to(dest, (X,) + dest.shape), src_v,
                valid=jnp.broadcast_to(ok, (X,) + ok.shape))

        birth = birth.replace(
            mean=scat_pl(birth.mean, inv_mean),
            cov=scat_pl(birth.cov, inv_cov),
            n_support=scat_pm(birth.n_support,
                              jnp.ones((P, Zc), jnp.int32)),
            n_checks=scat_pm(birth.n_checks, jnp.zeros((P, Zc), jnp.int32)),
            alive=planar.put_lane(
                birth.alive.astype(jnp.float32), dest,
                jnp.ones(dest.shape, jnp.float32), valid=ok) > 0.5,
        )

        # ---- candidate promotion / expiry (RBPHDFilter.hpp:1063-1080)
        checks = birth.n_checks + 1
        enough = birth.n_support >= cfg.birth_count_threshold
        trigger = birth.alive & (
            enough | (checks > cfg.birth_check_threshold) | few_in_fov[:, None]
        )
        promote = trigger & (enough | few_in_fov[:, None])
        gm = gm_ops.replace_weakest(
            gm, birth.mean, birth.cov,
            jnp.where(promote, cfg.birth_gaussian_weight, 0.0), promote,
        )
        birth = birth.replace(n_checks=checks, alive=birth.alive & ~trigger)
        return gm, birth

    # ---------------------------------------------------------------- update
    def update(self, state: RBPHDState, z, z_mask, meas=None) -> RBPHDState:
        """Reference: RBPHDFilter::update (RBPHDFilter.hpp:444-541).

        ``z``: [Zc, DZ] padded measurement set, ``z_mask``: [Zc] validity.
        """
        has_z = jnp.any(z_mask)
        new_state = self._update_body(state, z, z_mask, meas)
        # empty measurement set: only the update counter advances
        # (RBPHDFilter.hpp:448-452; note the reference leaves its stale unused-
        # measurement lists pointing into the now-empty measurement vector — we
        # keep the previous update's measurements instead)
        out = jax.tree_util.tree_map(
            lambda a, b: jnp.where(jnp.reshape(has_z, (1,) * a.ndim), b, a),
            state.replace(n_updates=state.n_updates + 1),
            new_state,
        )
        return out

    def _update_body(self, state: RBPHDState, z, z_mask, meas=None) -> RBPHDState:
        cfg = self.cfg
        meas = meas if meas is not None else self.meas
        pose = state.particles.pose
        nZ = jnp.sum(z_mask)

        # named scopes label each phase's kernels in profiler traces
        # ---------- map update (RBPHDFilter.hpp:543-725)
        with jax.named_scope("map_update"):
            gm_full, log_w, unused, n_in_fov, clutter_z = self._map_update(
                state, z, z_mask, meas)

        # ---------- importance weighting (RBPHDFilter.hpp:728-997)
        if not cfg.use_cluster_process:
            with jax.named_scope("importance"):
                log_w = self._importance_weights(
                    log_w, pose, gm_full, z, z_mask, clutter_z, nZ, meas
                )

        # ---------- merge + prune (RBPHDFilter.hpp:501-516)
        with jax.named_scope("merge"):
            gm_full = gm_ops.merge(gm_full, cfg.merge_threshold,
                                   cfg.merge_inflation)
        with jax.named_scope("prune"):
            gm_full = gm_ops.prune(gm_full, cfg.prune_threshold)

        with jax.named_scope("resample"):
            return self._resample_phase(state, gm_full, log_w, unused,
                                        n_in_fov, z, z_mask, nZ)

    def _map_update(self, state: RBPHDState, z, z_mask, meas):
        """Map-update phase: Pd, batched EKF multi-correct, the [P, Z, M]
        weight table with column normalization, missed-detection weights,
        unused-measurement flags, and the new-Gaussian append
        (RBPHDFilter.hpp:543-725 — the reference's ``mapUpdate`` /
        ``mapUpdate_kf`` timing phases).

        Returns ``(gm_full, log_w, unused, n_in_fov, clutter_z)``.
        """
        cfg = self.cfg
        gm = state.gm
        pose = state.particles.pose
        D = gm.dim
        P, M = gm.w.shape
        Zc = z.shape[0]
        nZ = jnp.sum(z_mask)
        dz = z.shape[-1]
        T_pz = min(cfg.new_per_z, M)
        clutter_z = jnp.broadcast_to(meas.clutter_intensity(z, nZ), (Zc,))
        log_w = state.particles.log_w

        # ------ probability of detection (RBPHDFilter.hpp:597-609)
        pd_raw, close = meas.pd_p(pose[:, None, :], gm.mean, gm.cov)
        pd_raw = jnp.where(gm.alive, pd_raw, 0.0)
        close = close & gm.alive
        pd = jnp.where(close, 1.0, pd_raw)  # close-to-limit: Pd = 1
        n_in_fov = jnp.sum((pd != 0.0) & gm.alive, axis=1).astype(jnp.int32)

        # ------ batched EKF correction (KalmanFilter.hpp:261-342)
        corr = correct_all(meas, self.gates, pose, gm.mean, gm.cov, z)

        # ------ nM x nZ weight table [P, Z, M] (RBPHDFilter.hpp:620-659)
        md_gate = corr.md2 <= cfg.new_gaussian_md_threshold**2
        cell = (
            gm.alive[:, None, :] & (pd[:, None, :] > 0.0)
            & z_mask[None, :, None] & md_gate & (corr.likelihood > 0.0)
        )
        w_tab = jnp.where(
            cell, pd[:, None, :] * gm.w[:, None, :] * corr.likelihood, 0.0
        )
        col_sum = clutter_z[None, :] + jnp.sum(w_tab, axis=2)  # [P, Zc]
        w_tab = jnp.where(z_mask[None, :, None],
                          w_tab / col_sum[:, :, None], 0.0)

        if cfg.use_cluster_process:
            # single-cluster-process weighting (RBPHDFilter.hpp:652-666)
            w_km_sum = jnp.sum(jnp.where(gm.alive, gm.w, 0.0), axis=1)
            log_prod = jnp.sum(
                jnp.where(z_mask[None, :], jnp.log(col_sum), 0.0), axis=1
            )
            log_w = log_w + w_km_sum + log_prod

        # ------ missed-detection weights (RBPHDFilter.hpp:686-706)
        w_km = gm.w
        w_miss = (1.0 - pd) * w_km
        row_sum = jnp.sum(w_tab, axis=1)                       # [P, M]
        delta = pd * w_km - row_sum
        comp = close & (w_km > cfg.birth_gaussian_weight) & (delta > 0.0)
        w_miss = jnp.where(comp, jnp.minimum(w_miss + delta, 1.0), w_miss)
        gm_old = gm.replace(
            w=jnp.where(gm.alive, w_miss, gm.w),
            w_prev=jnp.where(gm.alive, w_km, gm.w_prev),
        )

        # ------ unused measurements (RBPHDFilter.hpp:709-720)
        used = jnp.any(w_tab > 0.0, axis=2)                    # [P, Zc]
        unused = z_mask[None, :] & ~used

        # ------ hierarchical per-measurement selection: top-new_per_z
        # over the landmark lanes by iterated max (no sort) instead of a
        # flat top_k over the [P, Zc * M] table.  The MD gate keeps only a
        # few landmarks per measurement column, so per-column truncation
        # at new_per_z is the same deviation class as the new_capacity cap.
        m_ids = jnp.arange(M)
        v = w_tab
        col_vals, col_midx = [], []
        for _ in range(T_pz):
            am = jnp.argmax(v, axis=2)                         # [P,Zc]
            col_vals.append(jnp.max(v, axis=2))
            col_midx.append(am)
            v = jnp.where(m_ids[None, None, :] == am[:, :, None], 0.0, v)
        cand_w = jnp.concatenate(col_vals, axis=1)             # [P,Zc*T]
        cand_m = jnp.concatenate(col_midx, axis=1)

        # ---------- new Gaussians (RBPHDFilter.hpp:675-683): exact top-k
        # over the Zc * new_per_z survivors become new map entries.  Updated
        # means are reconstructed ONLY at the k selected cells from the
        # Kalman-gain planes (m + K nu, KalmanFilter.hpp:261-342), so the
        # full [D, P, Z, M] mean cube is never materialized.
        cand_z = jnp.tile(jnp.arange(Zc), T_pz)[None, :]           # [1,Zc*T]
        k = min(cfg.new_capacity, Zc * T_pz)
        top_w, top_c = jax.lax.top_k(cand_w, k)                    # [P,k]
        z_idx = jnp.take_along_axis(
            jnp.broadcast_to(cand_z, cand_m.shape), top_c, axis=1)
        m_idx = jnp.take_along_axis(cand_m, top_c, axis=1)
        ohm = planar.onehot(m_idx, M, cand_w.dtype)                # [P,k,M]
        # one fused lane-gather for every per-landmark plane we need
        planes = jnp.concatenate(
            [gm.mean, corr.K, corr.z_exp, corr.cov_upd], axis=0
        )                                                          # [X,P,M]
        sel = planar.take_lane(planes, ohm[None])                  # [X,P,k]
        mean_sel, K_sel, zexp_sel, new_cov = (
            sel[:D], sel[D:D + D * dz],
            sel[D + D * dz:D + D * dz + dz], sel[D + D * dz + dz:],
        )
        z_sel = [jnp.take(z[:, e], z_idx) for e in range(dz)]      # [P,k]
        innov_sel, _ = self.gates.innovation_p(
            [zexp_sel[e] for e in range(dz)], z_sel)
        new_mean = jnp.stack(
            [mean_sel[d] + sum(K_sel[d * dz + e] * innov_sel[e]
                               for e in range(dz))
             for d in range(D)]
        )                                                          # [D,P,k]
        new_alive = top_w > 0.0
        gm_full = gm_ops.replace_weakest(gm_old, new_mean, new_cov, top_w,
                                         new_alive, sorted_desc=True)
        return gm_full, log_w, unused, n_in_fov, clutter_z

    def _resample_phase(self, state: RBPHDState, gm_full, log_w, unused,
                        n_in_fov, z, z_mask, nZ) -> RBPHDState:
        """Resampling phase (RBPHDFilter.hpp:526-539) + state assembly."""
        cfg = self.cfg
        pose = state.particles.pose
        key, k_rs = jax.random.split(state.particles.key)
        allow = (
            (state.n_updates + 1 >= cfg.min_updates_before_resample)
            & (state.n_meas + nZ >= cfg.min_measurements_before_resample)
        )
        anc, new_log_w, did = resample_ops.maybe_resample(
            k_rs, log_w, cfg.ess_threshold, allow=allow
        )
        gathered = resample_ops.gather_particles(
            {
                "pose": pose, "gm": gm_full, "birth": state.birth,
                "unused": unused, "fov": n_in_fov,
            },
            anc,
        )

        particles = state.particles.replace(
            pose=gathered["pose"], log_w=new_log_w, parent=anc, key=key,
        )
        return RBPHDState(
            particles=particles,
            gm=gathered["gm"],
            birth=gathered["birth"],
            last_z=z,
            last_unused=gathered["unused"],
            n_in_fov=gathered["fov"],
            n_updates=jnp.where(did, 0, state.n_updates + 1),
            n_meas=jnp.where(did, 0, state.n_meas + nZ),
        )

    def _importance_weights(self, log_w, pose, gm: GMState, z, z_mask,
                            clutter_z, nZ, meas=None):
        """Reference: RBPHDFilter::importanceWeighting (RBPHDFilter.hpp:728-819)."""
        cfg = self.cfg
        meas = meas if meas is not None else self.meas
        D = gm.dim
        P, M = gm.w.shape
        E = cfg.eval_capacity
        dz = z.shape[-1]
        if E == 0:
            # nEvalPt=0 ("empty strategy", batchSim_rbphdslam_emptyStrat):
            # every particle has zero eval points, which the reference maps
            # to weight = denorm_min (RBPHDFilter.hpp:741-744) — uniform
            # after normalization
            return jnp.full_like(log_w, LOG_TINY)

        # eval-point selection: top-E by weight among w >= minWeight, Pd > 0
        pd_eval, _ = meas.pd_p(pose[:, None, :], gm.mean, gm.cov)
        elig = gm.alive & (gm.w >= cfg.eval_pt_min_weight) & (pd_eval > 0.0)
        score = jnp.where(elig, gm.w, -jnp.inf)
        _, eval_idx = jax.lax.top_k(score, E)              # [P, E]
        ohe = planar.onehot(eval_idx, M, gm.w.dtype)       # [P, E, M]
        eval_valid = planar.take_lane(elig.astype(gm.w.dtype), ohe) > 0.5
        eval_mean = planar.take_lane(gm.mean, ohe[None])   # [D, P, E]
        eval_pd = planar.take_lane(pd_eval, ohe)
        n_eval = jnp.sum(eval_valid, axis=1)

        # GM intensity at eval points before/after update (hpp:765-800)
        diff = [gm.mean[d][:, None, :] - eval_mean[d][:, :, None]
                for d in range(D)]                          # [P, E, M]
        cov_inv = planar.inv_sym(gm.cov, D)
        md2_em = planar.quad_sym(cov_inv[:, :, None, :], diff, D)  # [P, E, M]
        det_m = planar.det_sym(gm.cov, D)                   # [P, M]
        norm_m = jnp.sqrt((2.0 * jnp.pi) ** D * det_m)
        lik_em = jnp.exp(-0.5 * md2_em) / norm_m[:, None, :]
        lik_em = jnp.where(jnp.isfinite(lik_em), lik_em, 0.0)
        lik_em = jnp.where(gm.alive[:, None, :], lik_em, 0.0)
        tiny = jnp.asarray(gaussian.TINY, lik_em.dtype)
        hi = jax.lax.Precision.HIGHEST
        int_before = tiny + jnp.einsum("pem,pm->pe", lik_em,
                                       jnp.where(gm.alive, gm.w_prev, 0.0),
                                       precision=hi)
        int_after = tiny + jnp.einsum("pem,pm->pe", lik_em,
                                      jnp.where(gm.alive, gm.w, 0.0),
                                      precision=hi)
        log_int_ratio = jnp.sum(
            jnp.where(eval_valid, jnp.log(int_before) - jnp.log(int_after), 0.0),
            axis=1,
        )

        sum_before = jnp.sum(jnp.where(gm.alive, gm.w_prev, 0.0), axis=1)
        sum_after = jnp.sum(jnp.where(gm.alive, gm.w, 0.0), axis=1)

        # RFS measurement likelihood at eval points: expected measurement with
        # ZERO landmark covariance (S = R), gated (hpp:847-863)
        predE = meas.measure_p(pose[:, None, :], eval_mean)
        innov, _ = self.gates.innovation_p(
            [predE.z[d][:, :, None] for d in range(dz)],
            [z[:, d][None, None, :] for d in range(dz)],
        )                                                   # planes [P, E, Zc]
        S_inv = planar.inv_sym(predE.S, dz)
        md2 = planar.quad_sym(S_inv[:, :, :, None], innov, dz)
        norm = jnp.sqrt((2.0 * jnp.pi) ** dz * planar.det_sym(predE.S, dz))
        L = jnp.exp(-0.5 * md2) / norm[:, :, None]
        L = jnp.where(jnp.isfinite(L), L, 0.0)
        L = jnp.where(md2 <= cfg.weighting_md_threshold**2, L, 0.0)
        L = L * eval_pd[:, :, None]

        log_ci = jnp.log(meas.clutter_intensity_integral(nZ))
        log_rfs = rfs_log_likelihood(
            L, eval_pd, eval_valid, clutter_z[None, :], z_mask, log_ci,
            z_dp_max=cfg.z_dp_max,
        )

        out = log_w + log_rfs + log_int_ratio + (sum_after - sum_before)
        # no eval points: weight <- denorm_min (hpp:741-744)
        return jnp.where(n_eval == 0, LOG_TINY, out)
