"""FastSLAM 1.0 / MH-FastSLAM — batched, fixed-shape.

Re-implements the reference ``FastSLAM`` filter (reference:
FastSLAM.hpp:77-819): per-particle EKF landmark maps with log-odds existence
weights, Hungarian/Murty k-best data association, candidate-gated landmark
birth, and ESS-gated resampling with deep map copies.

Mapping to arrays:

* the per-particle in-range landmark selection (FastSLAM.hpp:450-465) becomes
  a rank-compaction: in-range landmarks are permuted to the leading rows of a
  fixed ``[NMZ, NMZ]`` log-likelihood table initialized at
  ``min_log_likelihood`` (exactly the reference's padded-square table);
* single-hypothesis DA = batched Hungarian max-sum on that table
  (= the best Murty solution after the reference's ``CostMatrix::reduce``
  optimization, FastSLAM.hpp:493-543);
* MH-FastSLAM (default ``mh_grow=True``) follows the reference's growth
  semantics: every particle expands into ``max_hypotheses`` Murty k-best
  hypotheses each update and the expanded set is KEPT as new particles
  until it would exceed ``n_particles_max``, at which point it
  force-resamples back to ``n_particles`` (FastSLAM.hpp:504-563 expansion,
  resampleWithMapCopy :728-757).  Here this is selection before
  materialization over a fixed ``n_particles_max`` axis — see
  ``_update_body_mh_grow``.  ``mh_grow=False`` keeps the legacy
  fixed-shape deviation that resamples to ``n_particles`` every update;
* the landmark-candidate pipeline is the same masked state machine as the
  RB-PHD birth (promoted candidates enter with weight
  ``logit(prior) * nChecks``, FastSLAM.hpp:692-698).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from rfs_slam_tpu.core import gaussian, planar, struct
from rfs_slam_tpu.core.state import BirthCandidates, GMState, ParticleState
from rfs_slam_tpu.ops import gm as gm_ops
from rfs_slam_tpu.ops import resample as resample_ops
from rfs_slam_tpu.ops.assignment import hungarian, murty, murty_gated
from rfs_slam_tpu.ops.ekf import InnovationGates, correct_single


def existence_log_odds_delta(pd, p_fa, prior, updated, locked):
    """Log-odds change of a landmark's existence weight after an update pass.

    Transcribes FastSLAM.hpp:599-620 exactly:

    * associated + KF-updated landmark::

        p(exist|Z) = ((1-Pd)*Pfa*prior + Pd*prior)
                     / (Pfa + (1-Pfa)*Pd*prior)

    * not updated (missed detection)::

        p(exist|Z) = (1-Pd)*prior / ((1-prior) + (1-Pd)*prior)

      unless the landmark is "locked" (w > landmarkLockWeight_), in which
      case p = 0.5 (log-odds delta 0).

    Returns ``log(p / (1-p))``.
    """
    p_up = ((1.0 - pd) * p_fa * prior + pd * prior) / (
        p_fa + (1.0 - p_fa) * pd * prior
    )
    p_down = ((1.0 - pd) * prior) / ((1.0 - prior) + (1.0 - pd) * prior)
    p = jnp.where(updated, p_up, jnp.where(locked, 0.5, p_down))
    return jnp.log(p) - jnp.log1p(-p)


@dataclasses.dataclass(frozen=True)
class FastSLAMConfig:
    """Mirrors ``FastSLAM::Config`` (FastSLAM.hpp:109-158) + capacities."""

    n_particles: int = 200
    map_capacity: int = 128
    z_capacity: int = 16
    nmz_capacity: int = 32           # DA table size (>= max in-range lmks, >= Zc)
    candidate_capacity: int = 16

    max_hypotheses: int = 1          # maxNDataAssocHypotheses_
    # particle-set growth cap for MH mode; None -> 3 * n_particles, the
    # reference constructor default (FastSLAM.hpp:335).  The particle axis
    # of the state is sized n_particles_max and the live set grows/shrinks
    # under it (see _update_body).
    n_particles_max: int | None = None
    # True (default): reference growth semantics — hypotheses become new
    # particles until the set exceeds n_particles_max, then force-resample
    # to n_particles (FastSLAM.hpp:728-757).  False: legacy fixed-shape
    # deviation that resamples to n_particles every update.
    mh_grow: bool = True
    # static cap on Murty children solved per expansion wave (see
    # ops/assignment.murty): the uncapped wave width is nmz_capacity - 1
    # while only ~n_in_range children are ever valid, and the vmapped-
    # Hungarian wave cost scales with width.  At the 2-D sim's measured
    # in-range counts (mean 11, p90 14, max 17) a cap truncates routinely,
    # but the children dropped are those with the lowest dual upper bound
    # and those provably outside max_da_loglik_diff of the best hypothesis
    # (murty prune_window), so the discard is the provably-weakest tail,
    # not the weakest-ranked rows.  The best hypothesis stays exact at
    # every measured shape.  None = unbounded (exact, slow).
    murty_child_cap: int | None = 6
    # static cap on the number of PARTICLE LANES that run the full Murty
    # expansion per update (ops/assignment.murty_gated): the root
    # Hungarian's dual bound certifies, per lane, whether a second
    # hypothesis can exist inside max_da_loglik_diff at all — on
    # low-ambiguity data most lanes cannot, and their k-1 expansion waves
    # are provably wasted.  Lanes certified single-hypothesis get the exact
    # murty result by construction; only AMBIGUOUS lanes beyond the budget
    # are truncated to their best hypothesis (the least-ambiguous actives
    # truncate first; overflow is measurable via murty_gated's counter).
    # None = every lane runs the full expansion (exact, slow).
    murty_lane_budget: int | None = None
    max_da_loglik_diff: float = 3.0  # maxDataAssocLogLikelihoodDiff_
    min_log_likelihood: float = -10.0  # minLogMeasurementLikelihood_
    existence_prior: float = 0.5     # landmarkExistencePrior_
    lock_weight: float = 10.0        # landmarkLockWeight_
    prune_threshold: float = -5.0    # mapExistencePruneThreshold_ (log odds)
    prune_z_threshold: int = 0       # pruningMeasurementsThreshold_
    cand_support_dist: float = 1.0
    cand_count_threshold: int = 1
    cand_check_threshold: int = 2
    cand_current_meas_count_threshold: int = 1
    min_updates_before_resample: int = 1
    min_measurements_before_resample: int = 1
    ess_threshold: float = 200.0


class FastSLAMState(struct.PyTreeNode):
    particles: ParticleState
    gm: GMState                 # w = log-odds existence
    cand: BirthCandidates
    n_in_fov: jax.Array         # [P] int32
    n_updates: jax.Array
    n_meas: jax.Array


class FastSLAMFilter:
    def __init__(self, motion, lmk_model, meas_model,
                 gates: InnovationGates, cfg: FastSLAMConfig):
        self.motion = motion
        self.lmk = lmk_model
        self.meas = meas_model
        self.gates = gates
        self.cfg = cfg

    @property
    def p_cap(self) -> int:
        """Size of the particle axis: n_particles_max in MH grow mode
        (the live set grows under it, FastSLAM.hpp:728-757), n_particles
        otherwise."""
        c = self.cfg
        if c.max_hypotheses > 1 and c.mh_grow:
            return c.n_particles_max or 3 * c.n_particles
        return c.n_particles

    def init_state(self, key, pose0, d: int = 2, dtype=jnp.float32):
        c = self.cfg
        P_cap = self.p_cap
        particles = ParticleState.init(key, P_cap, pose0, dtype)
        if P_cap != c.n_particles:
            # only the first n_particles slots start live
            live = jnp.arange(P_cap) < c.n_particles
            particles = particles.replace(
                log_w=jnp.where(live, -jnp.log(float(c.n_particles)),
                                -jnp.inf))
        return FastSLAMState(
            particles=particles,
            gm=GMState.empty(P_cap, c.map_capacity, d, dtype),
            cand=BirthCandidates.empty(P_cap, c.candidate_capacity, d, dtype),
            n_in_fov=jnp.zeros((P_cap,), jnp.int32),
            n_updates=jnp.zeros((), jnp.int32),
            n_meas=jnp.zeros((), jnp.int32),
        )

    # --------------------------------------------------------------- predict
    def predict(self, state: FastSLAMState, u, dt,
                use_model_noise=True, use_input_noise=False, input_cov=None,
                lmk=None):
        """FastSLAM::predict (FastSLAM.hpp:360-386): propagate + landmark step."""
        cfg = self.cfg
        lmk = self.lmk if lmk is None else lmk
        key, k_prop = jax.random.split(state.particles.key)
        prop_keys = jax.random.split(k_prop, state.particles.n_particles)
        pose = jax.vmap(
            lambda k, p: self.motion.sample(
                k, p, u, dt, use_model_noise, use_input_noise, input_cov
            )
        )(prop_keys, state.particles.pose)
        _, cov = lmk.static_step_p(state.gm.mean, state.gm.cov, dt)
        gm = state.gm.replace(
            cov=jnp.where(state.gm.alive[None], cov, state.gm.cov)
        )
        return state.replace(
            particles=state.particles.replace(pose=pose, key=key), gm=gm
        )

    # ---------------------------------------------------------------- update
    def update(self, state: FastSLAMState, z, z_mask, meas=None):
        has_z = jnp.any(z_mask)
        new_state = self._update_body(state, z, z_mask, meas=meas)
        out = jax.tree_util.tree_map(
            lambda a, b: jnp.where(jnp.reshape(has_z, (1,) * a.ndim), b, a),
            state.replace(n_updates=state.n_updates + 1),
            new_state,
        )
        return out

    # named scopes label each phase's kernels in profiler traces
    @jax.named_scope("da_table")
    def _da_table(self, pose, gm: GMState, z, z_mask, meas=None):
        """In-range compaction + padded log-likelihood table.

        Returns (table [P, NMZ, NMZ], lm_rank_idx [P, NMZ], row_valid,
        pd_rank, close_rank).
        """
        cfg = self.cfg
        meas = self.meas if meas is None else meas
        P, M = gm.w.shape
        NMZ = cfg.nmz_capacity
        pd, close = meas.pd_p(pose[:, None, :], gm.mean, gm.cov)
        in_range = gm.alive & ((pd > 0.0) | close)          # FastSLAM.hpp:456-465
        # rank-compact in-range landmarks to leading rows by DESCENDING
        # existence weight: when more landmarks are in range than the NMZ
        # table holds, truncation must drop the weakest (slot order is
        # arbitrary since replace_weakest; truncating by slot order cost
        # 3.6 -> 13.5 m RMSE on Victoria Park)
        score = jnp.where(in_range, gm.w, -jnp.inf)
        order = jnp.argsort(-score, axis=1, stable=True)     # [P, M]
        if M >= NMZ:
            lm_idx = order[:, :NMZ]
            row_valid = jnp.take_along_axis(in_range, lm_idx, axis=1)
        else:
            # pad with out-of-range index M: gathers clamp (masked by
            # row_valid=False) and scatters drop out-of-bounds rows
            lm_idx = jnp.pad(order, ((0, 0), (0, NMZ - M)), constant_values=M)
            row_valid = jnp.pad(
                jnp.take_along_axis(in_range, order, axis=1),
                ((0, 0), (0, NMZ - M)),
            )
        ohl = planar.onehot(jnp.minimum(lm_idx, M - 1), M, gm.w.dtype)
        lm_mean = planar.take_lane(gm.mean, ohl[None])
        lm_cov = planar.take_lane(gm.cov, ohl[None])
        pd_rank = planar.take_lane(pd, ohl)
        close_rank = planar.take_lane(close.astype(gm.w.dtype), ohl) > 0.5

        dz = z.shape[-1]
        pred = meas.measure_p(pose[:, None, :], lm_mean, lm_cov)
        innov, gate_ok = self.gates.innovation_p(
            [pred.z[d][:, :, None] for d in range(dz)],
            [z[:, d][None, None, :] for d in range(dz)],
        )                                                   # planes [P,NMZ,Zc]
        S_inv = planar.inv_sym(pred.S, dz)
        md2 = planar.quad_sym(S_inv[:, :, :, None], innov, dz)
        norm_log = 0.5 * (jnp.log(planar.det_sym(pred.S, dz))
                          + dz * gaussian.LOG_2PI)
        logL = -0.5 * md2 - norm_log[:, :, None]
        ok = row_valid[:, :, None] & pred.valid[:, :, None] & z_mask[None, None, :]
        logL = jnp.where(ok, jnp.maximum(logL, cfg.min_log_likelihood),
                         cfg.min_log_likelihood)

        Zc = z.shape[0]
        table = jnp.full((P, NMZ, NMZ), cfg.min_log_likelihood, logL.dtype)
        table = table.at[:, :, :Zc].set(logL)
        # KF innovation-gate pass per (rank, z) — the table itself stays
        # ungated like the reference's (FastSLAM.hpp:467-491; the gate only
        # aborts the later KF update), but MH grow mode needs it to predict
        # each hypothesis's exact post-update weight before materializing.
        gate_tab = jnp.zeros((P, NMZ, NMZ), bool).at[:, :, :Zc].set(
            gate_ok & jnp.broadcast_to(ok, gate_ok.shape))
        return table, lm_idx, row_valid, pd_rank, close_rank, gate_tab

    @jax.named_scope("apply")
    def _apply_hypothesis(self, pose, gm: GMState, z, z_mask, da, table,
                          lm_idx, row_valid, pd_rank, log_w, meas=None):
        """EKF updates + existence log-odds + weight for one DA hypothesis.

        ``da``: [P, NMZ] column assigned to each landmark rank.
        Reference: FastSLAM.hpp:569-621 + weight at :710-717.
        """
        cfg = self.cfg
        meas = self.meas if meas is None else meas
        P, M = gm.w.shape
        NMZ = cfg.nmz_capacity
        Zc = z.shape[0]
        rows = jnp.arange(P)[:, None]

        dz = z.shape[-1]
        da_z = jnp.minimum(da, Zc - 1)
        zsel = jnp.stack([jnp.take(z[:, d], da_z) for d in range(dz)])
        ranks = jnp.arange(NMZ)[None, :]
        L_da = table[rows, ranks, da]
        assoc_ok = (
            row_valid & (da < Zc)
            & jnp.take_along_axis(
                jnp.broadcast_to(z_mask[None, :], (P, Zc)), da_z, axis=1)
            & (L_da > cfg.min_log_likelihood)
        )

        lm_safe = jnp.minimum(lm_idx, M - 1)
        ohl = planar.onehot(lm_safe, M, gm.w.dtype)
        lm_mean = planar.take_lane(gm.mean, ohl[None])
        lm_cov = planar.take_lane(gm.cov, ohl[None])
        m_upd, c_upd, _, _, kf_ok = correct_single(
            meas, self.gates, pose[:, None, :], lm_mean, lm_cov, zsel
        )
        updated = assoc_ok & kf_ok                          # isUpdatePerformed

        # existence probability update (FastSLAM.hpp:599-620)
        nZ = jnp.sum(z_mask)
        n_clutter = meas.clutter_intensity_integral(nZ)
        p_fa = n_clutter / jnp.maximum(nZ, 1)
        w_rank = planar.take_lane(gm.w, ohl)
        locked = w_rank > cfg.lock_weight
        dw = existence_log_odds_delta(
            pd_rank, p_fa, cfg.existence_prior, updated, locked)
        w_new_rank = w_rank + jnp.where(row_valid, dw, 0.0)

        # scatter rank-space results back to landmark slots via one-hot
        # (lm_idx == M rows drop; see planar.put_lane)
        gm_mean = planar.put_lane(
            gm.mean, jnp.broadcast_to(lm_idx, (gm.mean.shape[0],) + lm_idx.shape),
            jnp.where(updated[None], m_upd, lm_mean))
        gm_cov = planar.put_lane(
            gm.cov, jnp.broadcast_to(lm_idx, (gm.cov.shape[0],) + lm_idx.shape),
            jnp.where(updated[None], c_upd, lm_cov))
        gm_w = planar.put_lane(gm.w, lm_idx,
                               jnp.where(row_valid, w_new_rank, w_rank))
        gm = gm.replace(mean=gm_mean, cov=gm_cov, w=gm_w)

        # measurement usage + particle weight (FastSLAM.hpp:611, 710-717)
        z_used = jnp.sum(
            (da_z[:, :, None] == jnp.arange(Zc)) & updated[:, :, None], axis=1
        ) > 0
        log_w = log_w + jnp.sum(jnp.where(updated, L_da, 0.0), axis=1)
        n_in_fov = jnp.sum(updated, axis=1).astype(jnp.int32)
        return gm, z_used, log_w, n_in_fov

    @jax.named_scope("candidates")
    def _candidates(self, pose, gm: GMState, cand: BirthCandidates,
                    z, z_mask, z_used, n_in_fov, meas=None):
        """Unused measurements -> landmark-candidate pipeline
        (FastSLAM.hpp:633-703; same machinery as the RB-PHD birth)."""
        cfg = self.cfg
        meas = self.meas if meas is None else meas
        P, Zc = z_used.shape
        dz = z.shape[-1]
        unused = z_mask[None, :] & ~z_used
        new_lm_w = jnp.log(cfg.existence_prior) - jnp.log1p(-cfg.existence_prior)
        z_planes = [z[:, d][None, :] for d in range(dz)]
        inv_mean, inv_cov = meas.inverse_p(pose[:, None, :], z_planes)
        few = n_in_fov <= cfg.cand_current_meas_count_threshold

        if cfg.cand_count_threshold == 1:
            w_new = jnp.where(unused, new_lm_w, 0.0)
            gm = gm_ops.replace_weakest(gm, inv_mean, inv_cov, w_new, unused)
            return gm, cand

        # match unused z to candidates
        pred = meas.measure_p(pose[:, None, :], cand.mean, cand.cov)
        innov, _ = self.gates.innovation_p(
            [pred.z[d][:, :, None] for d in range(dz)],
            [z[:, d][None, None, :] for d in range(dz)],
        )
        S_inv = planar.inv_sym(pred.S, dz)
        md2 = planar.quad_sym(S_inv[:, :, :, None], innov, dz)
        match = (cand.alive[:, :, None] & unused[:, None, :]
                 & (md2 <= cfg.cand_support_dist**2))
        c_ids = jnp.arange(cand.capacity)
        first_c = jnp.min(
            jnp.where(match, c_ids[None, :, None], cand.capacity), axis=1)
        z_matched = first_c < cand.capacity
        claim = match & (c_ids[None, :, None] == first_c[:, None, :])
        n_match = jnp.sum(claim, axis=2)
        best_z = jnp.argmin(jnp.where(claim, md2, jnp.inf), axis=2)
        z_best = jnp.stack([jnp.take(z[:, d], best_z) for d in range(dz)])
        m_upd, c_upd, _, _, _ = correct_single(
            meas, self.gates, pose[:, None, :], cand.mean, cand.cov, z_best
        )
        has_match = n_match > 0
        cand = cand.replace(
            mean=jnp.where(has_match[None], m_upd, cand.mean),
            cov=jnp.where(has_match[None], c_upd, cand.cov),
            n_support=cand.n_support + n_match,
        )

        is_new = unused & ~z_matched
        immediate = is_new & few[:, None]
        to_insert = is_new & ~immediate
        gm = gm_ops.replace_weakest(
            gm, inv_mean, inv_cov, jnp.where(immediate, new_lm_w, 0.0), immediate
        )

        # insert new candidates into free slots
        free_order = jnp.argsort(cand.alive, axis=1)
        src_order = jnp.argsort(~to_insert, axis=1)
        K = min(cand.capacity, Zc)
        dest = free_order[:, :K]
        src = src_order[:, :K]
        n_free = jnp.sum(~cand.alive, axis=1, keepdims=True)
        n_new = jnp.sum(to_insert, axis=1, keepdims=True)
        ok = jnp.arange(K)[None, :] < jnp.minimum(n_free, n_new)
        rows = jnp.arange(P)[:, None]

        def scat_pm(dst_arr, src_arr):
            src_v = jnp.take_along_axis(src_arr, src, axis=1)
            return planar.put_lane(dst_arr.astype(jnp.float32), dest,
                                   src_v.astype(jnp.float32),
                                   valid=ok).astype(dst_arr.dtype)

        def scat_pl(dst_arr, src_arr):
            src_v = jnp.take_along_axis(src_arr, src[None], axis=2)
            X = dst_arr.shape[0]
            return planar.put_lane(
                dst_arr, jnp.broadcast_to(dest, (X,) + dest.shape), src_v,
                valid=jnp.broadcast_to(ok, (X,) + ok.shape))

        cand = cand.replace(
            mean=scat_pl(cand.mean, inv_mean),
            cov=scat_pl(cand.cov, inv_cov),
            n_support=scat_pm(cand.n_support, jnp.ones((P, Zc), jnp.int32)),
            n_checks=scat_pm(cand.n_checks, jnp.zeros((P, Zc), jnp.int32)),
            alive=planar.put_lane(
                cand.alive.astype(jnp.float32), dest,
                jnp.ones(dest.shape, jnp.float32), valid=ok) > 0.5,
        )

        # promotion / expiry; promoted weight = logit(prior) * nChecks
        checks = cand.n_checks + 1
        enough = cand.n_support >= cfg.cand_count_threshold
        trigger = cand.alive & (
            enough | (checks > cfg.cand_check_threshold) | few[:, None])
        promote = trigger & (enough | few[:, None])
        gm = gm_ops.replace_weakest(
            gm, cand.mean, cand.cov,
            jnp.where(promote, new_lm_w * checks, 0.0), promote,
        )
        cand = cand.replace(n_checks=checks, alive=cand.alive & ~trigger)
        return gm, cand

    @jax.named_scope("assignment")
    def _mh_hypothesis_weights(self, state: FastSLAMState, z, z_mask,
                               table, row_valid, gate_tab):
        """Steps 1-2 of :meth:`_update_body_mh_grow`: the Murty k-best
        hypotheses of every live slot and their exact post-update
        log-weights, before any resampling.

        Returns ``(das [P_cap, H, NMZ], flat_lw [H * P_cap], count)`` with
        ``flat_lw`` h-major (index ``h * P_cap + p``) and ``count`` the
        number of kept hypotheses over live slots.
        """
        cfg = self.cfg
        P_cap = state.particles.pose.shape[0]
        H = cfg.max_hypotheses
        NMZ = cfg.nmz_capacity
        Zc = z.shape[0]
        nZ = jnp.sum(z_mask)
        log_w = state.particles.log_w
        alive_p = jnp.isfinite(log_w)

        # ---- k-best hypotheses per live slot (Murty real-assignment-block)
        n_m = jnp.sum(row_valid, axis=1)
        das, scores, valid = murty_gated(
            table, H, n_m, real_cols=nZ,
            child_cap=cfg.murty_child_cap,
            prune_window=cfg.max_da_loglik_diff,
            budget=cfg.murty_lane_budget)               # [Pc,H,NMZ], [Pc,H]
        keep = valid & (scores[:, :1] - scores <= cfg.max_da_loglik_diff)
        keep = keep & alive_p[:, None]
        keep = keep.at[:, 0].set(alive_p)               # best always kept
        n_h = jnp.maximum(jnp.sum(keep, axis=1), 1)

        # ---- exact predicted post-update weight per hypothesis
        rows = jnp.arange(P_cap)[:, None]
        ranks = jnp.arange(NMZ)[None, :]
        zmask_pad = jnp.zeros((NMZ,), bool).at[:Zc].set(z_mask)
        L_sums = []
        for h in range(H):
            da_h = das[:, h, :]                          # [Pc, NMZ]
            L_da = table[rows, ranks, da_h]
            ok = (
                row_valid & (da_h < Zc) & zmask_pad[da_h]
                & (L_da > cfg.min_log_likelihood)
                & gate_tab[rows, ranks, da_h]
            )
            L_sums.append(jnp.sum(jnp.where(ok, L_da, 0.0), axis=1))
        L_sum = jnp.stack(L_sums, axis=1)                # [Pc, H]
        hyp_lw = jnp.where(
            keep, log_w[:, None] - jnp.log(n_h)[:, None] + L_sum, -jnp.inf
        )
        # flat layout h * P_cap + p (matches the h-major concat convention)
        flat_lw = hyp_lw.T.reshape(-1)                   # [H * Pc]

        count = jnp.sum(jnp.where(alive_p, n_h, 0))
        return das, flat_lw, count

    def _update_body_mh_grow(self, state: FastSLAMState, z, z_mask,
                             table, lm_idx, row_valid, pd_rank, gate_tab,
                             meas=None):
        """MH-FastSLAM with the reference's particle-set growth semantics
        (FastSLAM.hpp:504-563 expansion + resampleWithMapCopy :728-757),
        restructured as **selection before materialization**:

        A hypothesis's post-update weight is ``w_p / n_h * exp(sum of gated
        table likelihoods of its performed associations)`` — fully known
        BEFORE any EKF map update (the reference computes the same sum during
        the update, :605, :717).  So instead of materializing up to
        ``n_live * H`` particle maps and then resampling, this:

        1. scores all ``P_cap x H`` hypotheses from the DA table,
        2. applies the reference's resampleWithMapCopy rule on the flat
           hypothesis distribution (force-resample to n_particles when the
           expanded count would exceed n_particles_max; else ESS-gated
           resample when the update/measurement gates are met; else keep all
           hypotheses as particles — count <= n_particles_max fits the
           fixed axis),
        3. gathers parent state and applies the ONE selected hypothesis per
           surviving slot.

        The EKF work is always ``P_cap`` slots instead of ``P_cap * H``.
        """
        cfg = self.cfg
        pose = state.particles.pose
        gm = state.gm
        P_cap = pose.shape[0]
        P_init = cfg.n_particles
        nZ = jnp.sum(z_mask)
        das, flat_lw, count = self._mh_hypothesis_weights(
            state, z, z_mask, table, row_valid, gate_tab)

        # ---- resampleWithMapCopy decision (FastSLAM.hpp:728-757)
        force = count > P_cap
        gates_met = (
            (state.n_updates + 1 >= cfg.min_updates_before_resample)
            & (state.n_meas + nZ >= cfg.min_measurements_before_resample)
        )
        ess = resample_ops.effective_count(flat_lw)
        do_rs = force | (gates_met & (ess <= cfg.ess_threshold))

        key, k_rs = jax.random.split(state.particles.key)
        # resample branch: n_particles_init ancestors from the hypothesis
        # distribution, uniform weights (ParticleFilter.hpp:399-492).
        # Draw exactly P_init ancestors so the systematic comb spans the FULL
        # hypothesis CDF — drawing P_cap and keeping the first P_init slots
        # would cover only the first P_init/P_cap of the cumulative
        # distribution, truncating the posterior (round-3 advisor finding).
        # Padding values past P_init are irrelevant: alive_rs masks them.
        anc_rs = jnp.pad(
            resample_ops.systematic_ancestors(k_rs, flat_lw, P_init),
            (0, P_cap - P_init))
        alive_rs = jnp.arange(P_cap) < P_init
        lw_rs = jnp.where(alive_rs, -jnp.log(float(P_init)), -jnp.inf)
        # keep branch: every kept hypothesis becomes a particle (count fits
        # P_cap since force is false), weights normalized
        keep_flat = jnp.isfinite(flat_lw)
        order = jnp.argsort(~keep_flat, stable=True).astype(jnp.int32)
        anc_keep = order[:P_cap]
        alive_keep = jnp.arange(P_cap) < jnp.sum(keep_flat)
        lw_keep = jnp.where(alive_keep, flat_lw[anc_keep], -jnp.inf)
        lw_keep = resample_ops.normalize_log_weights(lw_keep)

        anc_flat = jnp.where(do_rs, anc_rs, anc_keep)
        out_alive = jnp.where(do_rs, alive_rs, alive_keep)
        new_log_w = jnp.where(do_rs, lw_rs, lw_keep)
        new_log_w = jnp.where(out_alive, new_log_w, -jnp.inf)
        parent = (anc_flat % P_cap).astype(jnp.int32)
        hyp = (anc_flat // P_cap).astype(jnp.int32)

        # ---- materialize ONLY the selected hypotheses
        gathered = resample_ops.gather_particles(
            {"pose": pose, "gm": gm, "cand": state.cand}, parent)
        da_sel = das[parent, hyp]                        # [Pc, NMZ]
        table_sel = jnp.take(table, parent, axis=0)
        lm_idx_sel = jnp.take(lm_idx, parent, axis=0)
        row_valid_sel = jnp.take(row_valid, parent, axis=0)
        pd_rank_sel = jnp.take(pd_rank, parent, axis=0)

        gm2, z_used, _, n_in_fov = self._apply_hypothesis(
            gathered["pose"], gathered["gm"], z, z_mask, da_sel, table_sel,
            lm_idx_sel, row_valid_sel, pd_rank_sel,
            jnp.zeros((P_cap,)), meas=meas)

        # map management + candidate pipeline on the selected set
        do_prune = nZ >= cfg.prune_z_threshold
        pruned_alive = gm2.alive & (gm2.w >= cfg.prune_threshold)
        gm2 = gm2.replace(alive=jnp.where(do_prune, pruned_alive, gm2.alive))
        gm2, cand = self._candidates(gathered["pose"], gm2, gathered["cand"],
                                     z, z_mask, z_used, n_in_fov, meas=meas)
        # dead slots keep no map (their weight is -inf; scrub alive so map
        # statistics/logging never see ghost copies)
        gm2 = gm2.replace(alive=gm2.alive & out_alive[:, None])

        particles = state.particles.replace(
            pose=gathered["pose"], log_w=new_log_w, parent=parent, key=key)
        return FastSLAMState(
            particles=particles, gm=gm2, cand=cand, n_in_fov=n_in_fov,
            n_updates=jnp.where(do_rs, 0, state.n_updates + 1),
            n_meas=jnp.where(do_rs, 0, state.n_meas + nZ),
        )

    def _update_body(self, state: FastSLAMState, z, z_mask, meas=None):
        cfg = self.cfg
        pose = state.particles.pose
        gm = state.gm
        P = pose.shape[0]
        Zc = z.shape[0]
        nZ = jnp.sum(z_mask)

        table, lm_idx, row_valid, pd_rank, close_rank, gate_tab = (
            self._da_table(pose, gm, z, z_mask, meas=meas))

        H = cfg.max_hypotheses
        if H > 1 and cfg.mh_grow:
            return self._update_body_mh_grow(
                state, z, z_mask, table, lm_idx, row_valid, pd_rank,
                gate_tab, meas=meas)
        if H == 1:
            with jax.named_scope("assignment"):
                da, _ = jax.vmap(hungarian)(table)
            gm, z_used, log_w, n_in_fov = self._apply_hypothesis(
                pose, gm, z, z_mask, da, table, lm_idx, row_valid, pd_rank,
                state.particles.log_w, meas=meas)
            cand = state.cand
        else:
            # MH: k-best hypotheses, weight split (FastSLAM.hpp:547-563);
            # hypotheses outside maxDataAssocLogLikelihoodDiff of the best
            # collapse to the best hypothesis (weight re-merges at resample).
            # The real-assignment-block restriction (Murty::
            # setRealAssignmentBlock, MurtyAlgorithm.cpp:126-135) keeps the k
            # hypotheses distinct in the real nM x nZ block: without it, the
            # floor-tied padding cells of the NMZ table would enumerate
            # duplicate real associations and waste the hypothesis budget.
            n_m = jnp.sum(row_valid, axis=1)
            n_z_real = jnp.sum(z_mask)
            das, scores, valid = murty_gated(
                table, H, n_m, real_cols=n_z_real,
                child_cap=cfg.murty_child_cap,
                prune_window=cfg.max_da_loglik_diff,
                budget=cfg.murty_lane_budget)
            keep = valid & (scores[:, :1] - scores <= cfg.max_da_loglik_diff)
            das = jnp.where(keep[:, :, None], das, das[:, :1, :])
            n_h = jnp.sum(keep, axis=1)
            split_log_w = state.particles.log_w - jnp.log(n_h)

            def one_hyp(h):
                return self._apply_hypothesis(
                    pose, gm, z, z_mask, das[:, h, :], table, lm_idx,
                    row_valid, pd_rank, split_log_w, meas=meas)

            outs = [one_hyp(h) for h in range(H)]
            gms = [o[0] for o in outs]
            gm = GMState(
                mean=jnp.concatenate([g.mean for g in gms], axis=1),
                cov=jnp.concatenate([g.cov for g in gms], axis=1),
                w=jnp.concatenate([g.w for g in gms], axis=0),
                w_prev=jnp.concatenate([g.w_prev for g in gms], axis=0),
                alive=jnp.concatenate([g.alive for g in gms], axis=0),
            )
            z_used = jnp.concatenate([o[1] for o in outs], axis=0)
            log_w = jnp.concatenate([o[2] for o in outs], axis=0)
            n_in_fov = jnp.concatenate([o[3] for o in outs], axis=0)
            pose = jnp.tile(pose, (H, 1))
            c = state.cand
            cand = BirthCandidates(
                mean=jnp.tile(c.mean, (1, H, 1)),
                cov=jnp.tile(c.cov, (1, H, 1)),
                n_support=jnp.tile(c.n_support, (H, 1)),
                n_checks=jnp.tile(c.n_checks, (H, 1)),
                alive=jnp.tile(c.alive, (H, 1)),
            )
            # duplicated hypotheses (keep=False) carry -inf weight
            dup = ~keep.T.reshape(-1)
            log_w = jnp.where(dup, -jnp.inf, log_w)

        # map management: prune by existence log-odds (FastSLAM.hpp:628-631)
        do_prune = nZ >= cfg.prune_z_threshold
        pruned_alive = gm.alive & (gm.w >= cfg.prune_threshold)
        gm = gm.replace(alive=jnp.where(do_prune, pruned_alive, gm.alive))

        gm, cand = self._candidates(pose, gm, cand, z, z_mask, z_used,
                                    n_in_fov, meas=meas)

        # resampling back to n_particles (FastSLAM.hpp:728-757)
        key, k_rs = jax.random.split(state.particles.key)
        allow = (
            (state.n_updates + 1 >= cfg.min_updates_before_resample)
            & (state.n_meas + nZ >= cfg.min_measurements_before_resample)
        )
        if H == 1:
            anc, new_log_w, did = resample_ops.maybe_resample(
                k_rs, log_w, cfg.ess_threshold, allow=allow)
        else:
            anc_full = resample_ops.systematic_ancestors(k_rs, log_w, P)
            anc, new_log_w, did = anc_full, jnp.full((P,), -jnp.log(P)), jnp.asarray(True)
        gathered = resample_ops.gather_particles(
            {"pose": pose, "gm": gm, "cand": cand, "fov": n_in_fov}, anc)

        # recorded ancestry must index the PREVIOUS step's P-sized particle
        # array (Trajectory prev-chain, rbphdslam_VictoriaPark.cpp:631-660);
        # in MH mode `anc` indexes the H*P expanded set, where copy h*P + p
        # descends from particle p
        particles = state.particles.replace(
            pose=gathered["pose"], log_w=new_log_w, parent=anc % P, key=key)
        return FastSLAMState(
            particles=particles, gm=gathered["gm"], cand=gathered["cand"],
            n_in_fov=gathered["fov"],
            n_updates=jnp.where(did, 0, state.n_updates + 1),
            n_meas=jnp.where(did, 0, state.n_meas + nZ),
        )
