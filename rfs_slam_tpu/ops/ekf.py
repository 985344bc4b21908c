"""Batched per-landmark EKF correction — the hot inner kernel.

The reference's hottest loop is ``KalmanFilter::correct`` with one landmark
against all measurements, called per particle x per landmark inside the RB-PHD
map update (reference: KalmanFilter.hpp:261-342, called from
RBPHDFilter.hpp:597-641).  Here the whole ``[P, M]`` landmark batch is
corrected against the whole ``[Z]`` measurement batch in one shot:

* per (particle, landmark): expected measurement, innovation covariance
  S = H Sigma H^T + R, gain K = Sigma H^T S^-1, updated covariance
  (I - K H) Sigma symmetrized (KalmanFilter.hpp:240-245) — shared across all
  measurements exactly as in the multi-measurement ``correct``;
* per (particle, measurement, landmark): innovation (with the rotation-aware
  wrap and innovation gates of KalmanFilter_RngBrg.cpp:52-65), updated mean,
  Gaussian likelihood, and squared Mahalanobis distance.

Everything runs in the plane-major layout of :mod:`rfs_slam_tpu.core.planar`:
the landmark axis M is innermost and the whole kernel is one fused
elementwise program rather than batches of tiny ``[..., D, D]`` matrix
ops.  All "abort update" conditions of the reference become masks
in the returned ``valid`` array: invalid expected measurement (measure()
returning false), innovation-gate failures, and the NaN-likelihood guard
(KalmanFilter.hpp:253-254).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from rfs_slam_tpu.core import gaussian, planar, struct


class InnovationGates(struct.PyTreeNode):
    """Innovation gating config of the rotation-aware KF subclasses.

    ``wrap_dims`` marks measurement components that are angles (wrapped to
    +-pi before gating); thresholds < 0 disable the gate, matching the
    reference defaults (KalmanFilter_RngBrg.cpp:40-43).
    """

    thresholds: jax.Array  # [DZ]; <0 disables
    wrap_dims: tuple = struct.field(pytree_node=False, default=())

    @classmethod
    def range_bearing(cls, range_t: float = -1.0, bearing_t: float = -1.0):
        """KalmanFilter_RngBrg gates (reference: KalmanFilter_RngBrg.cpp:52-65)."""
        return cls(thresholds=np.array([range_t, bearing_t], np.float32), wrap_dims=(1,))

    @classmethod
    def victoria_park(cls, range_t: float = -1.0, bearing_t: float = -1.0,
                      diam_t: float = -1.0):
        """KalmanFilter_VictoriaPark gates (KalmanFilter_VictoriaPark.hpp:56-74)."""
        return cls(thresholds=np.array([range_t, bearing_t, diam_t], np.float32),
                   wrap_dims=(1,))

    @classmethod
    def none(cls, dz: int):
        return cls(thresholds=-jnp.ones((dz,)), wrap_dims=())

    def innovation(self, z_exp: jax.Array, z_act: jax.Array):
        """Stacked-layout innovation: returns (innovation, pass_mask)."""
        innov = z_act - z_exp
        for d in self.wrap_dims:
            innov = innov.at[..., d].set(gaussian.wrap_angle(innov[..., d]))
        gate_on = self.thresholds > 0
        ok = jnp.all(
            jnp.where(gate_on, jnp.abs(innov) <= self.thresholds, True), axis=-1
        )
        return innov, ok

    def innovation_p(self, z_exp, z_act):
        """Plane-layout innovation.

        ``z_exp``: list/stack of DZ planes; ``z_act``: list/stack of DZ planes
        (broadcast-compatible).  Returns (list of innovation planes, ok plane).
        """
        dz = len(z_exp)
        innov = []
        ok = True
        for d in range(dz):
            e = z_act[d] - z_exp[d]
            if d in self.wrap_dims:
                e = gaussian.wrap_angle(e)
            innov.append(e)
            t = self.thresholds[d]
            ok = ok & jnp.where(t > 0, jnp.abs(e) <= t, True)
        return innov, ok


class PlanarCorrection(NamedTuple):
    """Output of :func:`correct_all` (plane-major).

    Shapes: P = particles, Z = measurements, M = landmarks, D = landmark dim,
    DZ = measurement dim, T/TZ = packed-triangle sizes.

    Per-measurement updated means are NOT materialized (a [D, P, Z, M] cube
    dominated the map-update's HBM traffic); instead the Kalman gain planes
    ``K`` are returned and consumers reconstruct means only where needed:
    ``mean_upd[d] = lm_mean[d] + sum_e K[d*DZ+e] * innov[e]`` (see
    :func:`updated_mean_planes`).
    """

    z_exp: jax.Array     # [DZ, P, M]
    S: jax.Array         # [TZ, P, M]  innovation covariance (packed)
    cov_upd: jax.Array   # [T, P, M]   shared across measurements (packed)
    K: jax.Array         # [D*DZ, P, M] Kalman gain planes (row-major)
    likelihood: jax.Array  # [P, Z, M]  N(z; z_exp, S), 0 where invalid
    md2: jax.Array       # [P, Z, M]
    valid: jax.Array     # [P, Z, M] bool (measure-valid & gates passed)
    measure_valid: jax.Array  # [P, M] bool


def correct_all(model, gates: InnovationGates, pose: jax.Array,
                lm_mean: jax.Array, lm_cov: jax.Array,
                z: jax.Array) -> PlanarCorrection:
    """One-landmark-times-all-measurements EKF correction, fully batched.

    Args:
      model: a measurement model exposing the planar API ``measure_p``.
      gates: innovation gates (rotation-aware subclass behavior).
      pose:  [P, 3] particle poses.
      lm_mean: [D, P, M] landmark mean planes.
      lm_cov:  [T, P, M] packed landmark covariance planes.
      z: [Z, DZ] measurements; invalid entries are masked by the caller via
        the returned per-measurement arrays.
    """
    D = lm_mean.shape[0]
    pred = model.measure_p(pose[:, None, :], lm_mean, lm_cov)  # planes [P, M]
    DZ = len(pred.z)
    S_inv = planar.inv_sym(pred.S, DZ)                     # [TZ, P, M]
    # K = Sigma H^T S^-1  (rows: D x DZ)
    C_rows = planar.sym_rows(lm_cov, D)
    Ht = planar.transpose_rows(pred.H)                     # D x DZ
    CHt = planar.matmul(C_rows, Ht)                        # D x DZ
    K = planar.matmul(CHt, planar.sym_rows(S_inv, DZ))     # D x DZ
    # NaN guard at [P, M] cost (the reference's, KalmanFilter.hpp:253-254):
    # models clamp their Jacobian denominators so H stays finite even for
    # dead slots (see models/measurement.py), but scrub the gain as a
    # model-agnostic backstop — every downstream plane (mean_upd, cov_upd)
    # is an affine function of K, and planes MUST stay finite everywhere
    # because one-hot lane gathers (planar.take_lane) turn a single NaN
    # lane into NaN for every gathered value.
    K = [[jnp.where(jnp.isfinite(k), k, 0.0) for k in row] for row in K]
    # cov_upd = (I - K H) Sigma, symmetrized (KalmanFilter.hpp:240-245)
    KH = planar.matmul(K, pred.H)                          # D x D
    A = [[(1.0 if i == j else 0.0) - KH[i][j] for j in range(D)]
         for i in range(D)]
    U = planar.matmul(A, C_rows)
    cov_upd = jnp.stack(
        [0.5 * (U[i][j] + U[j][i]) for i in range(D) for j in range(i, D)]
    )

    # innovations: planes [P, Z, M]
    z_act = [z[:, d][None, :, None] for d in range(DZ)]
    z_exp_b = [pred.z[d][:, None, :] for d in range(DZ)]
    innov, gate_ok = gates.innovation_p(z_exp_b, z_act)

    md2 = planar.quad_sym(S_inv[:, :, None, :], innov, DZ)  # [P, Z, M]
    det_S = planar.det_sym(pred.S, DZ)                      # [P, M]
    norm = jnp.sqrt((2.0 * jnp.pi) ** DZ * det_S)
    lik = jnp.exp(-0.5 * md2) / norm[:, None, :]
    lik = jnp.where(jnp.isfinite(lik), lik, 0.0)

    valid = gate_ok & pred.valid[:, None, :]
    lik = jnp.where(valid, lik, 0.0)

    return PlanarCorrection(
        z_exp=jnp.stack(list(pred.z)), S=pred.S, cov_upd=cov_upd,
        K=jnp.stack([K[d][e] for d in range(D) for e in range(DZ)]),
        likelihood=lik, md2=md2, valid=valid,
        measure_valid=pred.valid,
    )


def updated_mean_planes(corr: PlanarCorrection, gates: InnovationGates,
                        lm_mean: jax.Array, z: jax.Array,
                        d: int) -> jax.Array:
    """Dense per-measurement updated means ``[D, P, Z, M]``.

    Boundary/test use only — the filter hot path reconstructs means at
    selected (z, m) cells instead of materializing this cube
    (KalmanFilter.hpp:261-342's per-measurement ``m + K nu``).
    """
    dz = corr.z_exp.shape[0]
    z_act = [z[:, e][None, :, None] for e in range(dz)]
    z_exp_b = [corr.z_exp[e][:, None, :] for e in range(dz)]
    innov, _ = gates.innovation_p(z_exp_b, z_act)
    return jnp.stack(
        [
            lm_mean[i][:, None, :]
            + sum(corr.K[i * dz + e][:, None, :] * innov[e]
                  for e in range(dz))
            for i in range(d)
        ]
    )


def correct_single(model, gates: InnovationGates, pose: jax.Array,
                   lm_mean: jax.Array, lm_cov: jax.Array, z):
    """Single-measurement EKF correct for each landmark in the batch (planar).

    ``pose`` (..., 3); ``lm_mean`` [D, ...], ``lm_cov`` [T, ...] planes;
    ``z`` [DZ, ...] planes — all batch axes aligned.  Returns
    ``(mean_upd, cov_upd, likelihood, md2, valid)`` in the same plane layout;
    where invalid, the original landmark is returned unchanged (the reference
    skips the update, KalmanFilter.hpp:215-217).
    """
    D = lm_mean.shape[0]
    pred = model.measure_p(pose, lm_mean, lm_cov)
    DZ = len(pred.z)
    S_inv = planar.inv_sym(pred.S, DZ)
    C_rows = planar.sym_rows(lm_cov, D)
    Ht = planar.transpose_rows(pred.H)
    K = planar.matmul(planar.matmul(C_rows, Ht), planar.sym_rows(S_inv, DZ))
    KH = planar.matmul(K, pred.H)
    A = [[(1.0 if i == j else 0.0) - KH[i][j] for j in range(D)]
         for i in range(D)]
    U = planar.matmul(A, C_rows)
    cov_upd = jnp.stack(
        [0.5 * (U[i][j] + U[j][i]) for i in range(D) for j in range(i, D)]
    )
    innov, gate_ok = gates.innovation_p(list(pred.z), [z[d] for d in range(DZ)])
    md2 = planar.quad_sym(S_inv, innov, DZ)
    det_S = planar.det_sym(pred.S, DZ)
    norm = jnp.sqrt((2.0 * jnp.pi) ** DZ * det_S)
    lik = jnp.exp(-0.5 * md2) / norm
    lik = jnp.where(jnp.isfinite(lik), lik, 0.0)
    valid = gate_ok & pred.valid
    mean_upd = jnp.stack(
        [lm_mean[d] + sum(K[d][e] * innov[e] for e in range(DZ))
         for d in range(D)]
    )
    # NaN guard (KalmanFilter.hpp:253-254): a degenerate input (r = 0) can
    # make the update NaN while the model still reports valid; keep the
    # original Gaussian there so the planes stay finite (see correct_all).
    finite = (jnp.all(jnp.isfinite(mean_upd), axis=0)
              & jnp.all(jnp.isfinite(cov_upd), axis=0))
    valid = valid & finite
    mean_out = jnp.where(valid[None], mean_upd, lm_mean)
    cov_out = jnp.where(valid[None], cov_upd, lm_cov)
    return mean_out, cov_out, jnp.where(valid, lik, 0.0), md2, valid
