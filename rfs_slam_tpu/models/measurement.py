"""Measurement models as batched pure functions.

Covers the reference's L1 measurement-model family
(MeasurementModel.hpp:51-227 and the Rng1D / RngBrg / XY concrete models).
Each model provides

* ``measure(pose, lm_mean, lm_cov)`` -> ``MeasurePrediction`` with the
  expected measurement, its covariance S = H_m Sigma_m H_m^T + R (particle
  poses carry no covariance in the filters, so the H_x Sigma_x H_x^T term of
  the reference is zero — MeasurementModel_RngBrg.cpp:96-103), the Jacobians,
  and a validity mask replacing the bool return;
* ``inverse(pose, z)`` -> landmark mean/cov via the inverse model
  (used for births, MeasurementModel_RngBrg.cpp:117-136);
* ``pd(pose, lm_mean)`` -> (probability of detection, close-to-limit mask)
  with the min/max range + buffer-zone logic of
  MeasurementModel_RngBrg.cpp:138-167;
* ``clutter_intensity`` / ``clutter_intensity_integral``.

All functions broadcast: pose ``(..., 3)`` against landmark ``(..., D)``
batches; callers align axes (e.g. pose ``[P, 1, 3]`` vs landmarks
``[P, M, 2]``).

The Victoria Park lidar model lives in
:mod:`rfs_slam_tpu.models.victoria_park`.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from rfs_slam_tpu.core import gaussian, struct

# floor for squared-range Jacobian denominators (see RangeBearing.measure):
# keeps H finite for a landmark exactly at the sensor; shared constant so the
# victoria-park model's clamp cannot drift from this one
_R2_TINY = gaussian.R2_TINY


class MeasurePrediction(NamedTuple):
    z: jax.Array          # (..., DZ)   expected measurement
    S: jax.Array          # (..., DZ, DZ) innovation covariance (lmk term + R)
    H_lmk: jax.Array      # (..., DZ, D)
    H_pose: jax.Array     # (..., DZ, 3)
    valid: jax.Array      # (...,) bool — the reference's bool return value


class PlanarPrediction(NamedTuple):
    """Plane-layout prediction (see :mod:`rfs_slam_tpu.core.planar`).

    Produced by the ``measure_p`` hot-path API: every element is a plane (or
    list of planes) with the full batch shape, so the EKF kernel fuses into
    one elementwise program.
    """

    z: tuple              # DZ planes
    S: jax.Array          # [TZ, ...] packed innovation covariance planes
    H: list               # DZ x D nested list of H_lmk planes
    valid: jax.Array      # bool plane


class RangeBearing(struct.PyTreeNode):
    """2-D range-bearing model (reference: MeasurementModel_RngBrg.cpp).

    Attributes:
      R: [2, 2] measurement noise (already inflated by the app).
      pd: scalar probability of detection inside the sensing annulus.
      clutter: uniform clutter intensity (per unit of measurement space).
      r_max, r_min, r_buf: sensing annulus and buffer zone.
    """

    R: jax.Array
    pd_const: jax.Array = struct.field(default=0.95)
    clutter: jax.Array = struct.field(default=0.1)
    r_max: jax.Array = struct.field(default=5.0)
    r_min: jax.Array = struct.field(default=0.3)
    r_buf: jax.Array = struct.field(default=0.25)

    def measure(self, pose: jax.Array, lm_mean: jax.Array,
                lm_cov: jax.Array | None = None) -> MeasurePrediction:
        dx = lm_mean[..., 0] - pose[..., 0]
        dy = lm_mean[..., 1] - pose[..., 1]
        r2 = dx * dx + dy * dy
        r = jnp.sqrt(r2)
        b = gaussian.wrap_angle(jnp.arctan2(dy, dx) - pose[..., 2])
        z = jnp.stack([r, b], axis=-1)

        # Jacobian denominators clamped away from 0: a landmark exactly at
        # the sensor (dead padded slots + a particle at the origin) must
        # yield FINITE H (= 0 here), not NaN — downstream one-hot gathers
        # require finite planes everywhere (core/planar.take_lane)
        r2s = jnp.maximum(r2, _R2_TINY)
        rs = jnp.sqrt(r2s)
        H_lmk = jnp.stack(
            [
                jnp.stack([dx / rs, dy / rs], axis=-1),
                jnp.stack([-dy / r2s, dx / r2s], axis=-1),
            ],
            axis=-2,
        )
        zero = jnp.zeros_like(r)
        H_pose = jnp.stack(
            [
                jnp.stack([-dx / rs, -dy / rs, zero], axis=-1),
                jnp.stack([dy / r2s, -dx / r2s, zero - 1.0], axis=-1),
            ],
            axis=-2,
        )
        S = jnp.broadcast_to(self.R, z.shape + (2,))
        if lm_cov is not None:
            S = S + gaussian.sandwich(H_lmk, lm_cov)
        valid = (r <= self.r_max) & (r >= self.r_min)
        return MeasurePrediction(z, S, H_lmk, H_pose, valid)

    def measure_p(self, pose, mean, cov=None) -> PlanarPrediction:
        """Plane-layout measure: ``mean[2, ...]``, ``cov[3, ...]`` packed."""
        from rfs_slam_tpu.core import planar

        dx = mean[0] - pose[..., 0]
        dy = mean[1] - pose[..., 1]
        r2 = dx * dx + dy * dy
        r = jnp.sqrt(r2)
        b = gaussian.wrap_angle(jnp.arctan2(dy, dx) - pose[..., 2])
        # clamped denominators: see measure()
        r2s = jnp.maximum(r2, _R2_TINY)
        rs = jnp.sqrt(r2s)
        H = [[dx / rs, dy / rs], [-dy / r2s, dx / r2s]]
        if cov is not None:
            S = planar.sandwich_sym(H, cov, 2, R=self.R)
        else:
            S = jnp.stack([jnp.broadcast_to(v, r.shape)
                           for v in (self.R[0, 0], self.R[0, 1], self.R[1, 1])])
        valid = (r <= self.r_max) & (r >= self.r_min)
        return PlanarPrediction((r, b), S, H, valid)

    def inverse_p(self, pose, z):
        """Plane-layout inverse: ``z`` = DZ planes -> (mean[2,...], cov[3,...])."""
        from rfs_slam_tpu.core import planar

        a = pose[..., 2] + z[1]
        c, s = jnp.cos(a), jnp.sin(a)
        r = z[0]
        mean = jnp.stack([pose[..., 0] + r * c, pose[..., 1] + r * s])
        Hinv = [[c, -r * s], [s, r * c]]
        cov = planar.sandwich_sym(Hinv, planar.pack_sym(self.R), 2)
        return mean, cov

    def pd_p(self, pose, mean, cov=None):
        """Plane-layout Pd: returns ([...] pd plane, [...] close plane)."""
        dx = mean[0] - pose[..., 0]
        dy = mean[1] - pose[..., 1]
        r = jnp.sqrt(dx * dx + dy * dy)
        inside = (r <= self.r_max) & (r >= self.r_min)
        pd = jnp.where(inside, self.pd_const, 0.0)
        near_inner = inside & (
            (r >= self.r_max - self.r_buf) | (r <= self.r_min + self.r_buf)
        )
        near_outer = (~inside) & (
            (r <= self.r_max + self.r_buf) & (r >= self.r_min - self.r_buf)
        )
        return pd, near_inner | near_outer

    def inverse(self, pose: jax.Array, z: jax.Array):
        a = pose[..., 2] + z[..., 1]
        c, s = jnp.cos(a), jnp.sin(a)
        r = z[..., 0]
        mean = jnp.stack([pose[..., 0] + r * c, pose[..., 1] + r * s], axis=-1)
        Hinv = jnp.stack(
            [
                jnp.stack([c, -r * s], axis=-1),
                jnp.stack([s, r * c], axis=-1),
            ],
            axis=-2,
        )
        cov = gaussian.sandwich(Hinv, self.R)
        return mean, cov

    def pd(self, pose: jax.Array, lm_mean: jax.Array, lm_cov=None):
        dx = lm_mean[..., 0] - pose[..., 0]
        dy = lm_mean[..., 1] - pose[..., 1]
        r = jnp.sqrt(dx * dx + dy * dy)
        inside = (r <= self.r_max) & (r >= self.r_min)
        pd = jnp.where(inside, self.pd_const, 0.0)
        near_inner = inside & (
            (r >= self.r_max - self.r_buf) | (r <= self.r_min + self.r_buf)
        )
        near_outer = (~inside) & (
            (r <= self.r_max + self.r_buf) & (r >= self.r_min - self.r_buf)
        )
        return pd, near_inner | near_outer

    def clutter_intensity(self, z=None, n_z=None):
        return self.clutter

    def clutter_intensity_integral(self, n_z=None):
        # sensing "area" in measurement space: 2*pi*(r_max - r_min)
        # (MeasurementModel_RngBrg.cpp:175-178)
        return self.clutter * 2.0 * jnp.pi * (self.r_max - self.r_min)

    def sample(self, key, pose, lm_mean):
        """Sample a measurement (reference: MeasurementModel.hpp:129-158)."""
        pred = self.measure(pose, lm_mean)
        z = gaussian.sample(key, pred.z, jnp.broadcast_to(self.R, pred.z.shape + (2,)))
        return z, pred.valid


class XY(struct.PyTreeNode):
    """Robot-frame x-y measurement model (reference: MeasurementModel_XY.cpp)."""

    R: jax.Array
    pd_const: jax.Array = struct.field(default=0.95)
    clutter: jax.Array = struct.field(default=0.1)
    r_max: jax.Array = struct.field(default=5.0)
    r_min: jax.Array = struct.field(default=0.3)
    r_buf: jax.Array = struct.field(default=0.25)

    def measure(self, pose, lm_mean, lm_cov=None) -> MeasurePrediction:
        dx = lm_mean[..., 0] - pose[..., 0]
        dy = lm_mean[..., 1] - pose[..., 1]
        c, s = jnp.cos(pose[..., 2]), jnp.sin(pose[..., 2])
        z = jnp.stack([c * dx + s * dy, -s * dx + c * dy], axis=-1)
        H_lmk = jnp.stack(
            [jnp.stack([c, s], axis=-1), jnp.stack([-s, c], axis=-1)], axis=-2
        )
        H_pose = jnp.stack(
            [
                jnp.stack([-c, -s, -dx * s + dy * c], axis=-1),
                jnp.stack([s, -c, -dx * c - dy * s], axis=-1),
            ],
            axis=-2,
        )
        S = jnp.broadcast_to(self.R, z.shape + (2,))
        if lm_cov is not None:
            S = S + gaussian.sandwich(H_lmk, lm_cov)
        r = jnp.sqrt(dx * dx + dy * dy)
        valid = (r <= self.r_max) & (r >= self.r_min)
        return MeasurePrediction(z, S, H_lmk, H_pose, valid)

    def measure_p(self, pose, mean, cov=None) -> PlanarPrediction:
        from rfs_slam_tpu.core import planar

        dx = mean[0] - pose[..., 0]
        dy = mean[1] - pose[..., 1]
        c, s = jnp.cos(pose[..., 2]), jnp.sin(pose[..., 2])
        zx = c * dx + s * dy
        zy = -s * dx + c * dy
        cb = jnp.broadcast_to(c, dx.shape)
        sb = jnp.broadcast_to(s, dx.shape)
        H = [[cb, sb], [-sb, cb]]
        if cov is not None:
            S = planar.sandwich_sym(H, cov, 2, R=self.R)
        else:
            S = jnp.stack([jnp.broadcast_to(v, dx.shape)
                           for v in (self.R[0, 0], self.R[0, 1], self.R[1, 1])])
        r = jnp.sqrt(dx * dx + dy * dy)
        valid = (r <= self.r_max) & (r >= self.r_min)
        return PlanarPrediction((zx, zy), S, H, valid)

    def inverse_p(self, pose, z):
        from rfs_slam_tpu.core import planar

        c, s = jnp.cos(pose[..., 2]), jnp.sin(pose[..., 2])
        mean = jnp.stack([
            pose[..., 0] + c * z[0] - s * z[1],
            pose[..., 1] + s * z[0] + c * z[1],
        ])
        zx = jnp.broadcast_to(c, mean[0].shape)
        zs = jnp.broadcast_to(s, mean[0].shape)
        Hinv = [[zx, -zs], [zs, zx]]
        cov = planar.sandwich_sym(Hinv, planar.pack_sym(self.R), 2)
        return mean, cov

    def pd_p(self, pose, mean, cov=None):
        dx = mean[0] - pose[..., 0]
        dy = mean[1] - pose[..., 1]
        r = jnp.sqrt(dx * dx + dy * dy)
        inside = (r <= self.r_max) & (r >= self.r_min)
        pd = jnp.where(inside, self.pd_const, 0.0)
        near_inner = inside & (
            (r >= self.r_max - self.r_buf) | (r <= self.r_min + self.r_buf)
        )
        near_outer = (~inside) & (
            (r <= self.r_max + self.r_buf) & (r >= self.r_min - self.r_buf)
        )
        return pd, near_inner | near_outer

    def inverse(self, pose, z):
        c, s = jnp.cos(pose[..., 2]), jnp.sin(pose[..., 2])
        mean = jnp.stack(
            [
                pose[..., 0] + c * z[..., 0] - s * z[..., 1],
                pose[..., 1] + s * z[..., 0] + c * z[..., 1],
            ],
            axis=-1,
        )
        Hinv = jnp.stack(
            [jnp.stack([c, -s], axis=-1), jnp.stack([s, c], axis=-1)], axis=-2
        )
        cov = gaussian.sandwich(Hinv, self.R)
        return mean, cov

    def pd(self, pose, lm_mean, lm_cov=None):
        dx = lm_mean[..., 0] - pose[..., 0]
        dy = lm_mean[..., 1] - pose[..., 1]
        r = jnp.sqrt(dx * dx + dy * dy)
        inside = (r <= self.r_max) & (r >= self.r_min)
        pd = jnp.where(inside, self.pd_const, 0.0)
        near_inner = inside & (
            (r >= self.r_max - self.r_buf) | (r <= self.r_min + self.r_buf)
        )
        near_outer = (~inside) & (
            (r <= self.r_max + self.r_buf) & (r >= self.r_min - self.r_buf)
        )
        return pd, near_inner | near_outer

    def clutter_intensity(self, z=None, n_z=None):
        return self.clutter

    def clutter_intensity_integral(self, n_z=None):
        # area of the sensing annulus (x-y measurement space)
        return self.clutter * jnp.pi * (self.r_max**2 - self.r_min**2)


class Range1D(struct.PyTreeNode):
    """1-D range model (reference: MeasurementModel_Rng1D.cpp)."""

    R: jax.Array  # [1, 1]
    pd_const: jax.Array = struct.field(default=0.95)
    clutter: jax.Array = struct.field(default=0.1)
    r_max: jax.Array = struct.field(default=5.0)
    r_min: jax.Array = struct.field(default=0.3)
    r_buf: jax.Array = struct.field(default=0.25)

    def measure(self, pose, lm_mean, lm_cov=None) -> MeasurePrediction:
        z = lm_mean - pose
        one = jnp.ones(z.shape[:-1] + (1, 1), z.dtype)
        S = jnp.broadcast_to(self.R, z.shape + (1,))
        if lm_cov is not None:
            S = S + lm_cov
        r = jnp.abs(z[..., 0])
        valid = (r <= self.r_max) & (r >= self.r_min)
        return MeasurePrediction(z, S, one, -one, valid)

    def measure_p(self, pose, mean, cov=None) -> PlanarPrediction:
        zz = mean[0] - pose[..., 0]
        one = jnp.ones_like(zz)
        S = (cov + self.R[0, 0]) if cov is not None else jnp.stack(
            [jnp.broadcast_to(self.R[0, 0], zz.shape)]
        )
        r = jnp.abs(zz)
        valid = (r <= self.r_max) & (r >= self.r_min)
        return PlanarPrediction((zz,), S, [[one]], valid)

    def inverse_p(self, pose, z):
        mean = jnp.stack([pose[..., 0] + z[0]])
        cov = jnp.broadcast_to(self.R[0, 0], mean.shape)
        return mean, cov

    def pd_p(self, pose, mean, cov=None):
        r = jnp.abs(mean[0] - pose[..., 0])
        inside = (r <= self.r_max) & (r >= self.r_min)
        pd = jnp.where(inside, self.pd_const, 0.0)
        near_inner = inside & (
            (r >= self.r_max - self.r_buf) | (r <= self.r_min + self.r_buf)
        )
        near_outer = (~inside) & (
            (r <= self.r_max + self.r_buf) & (r >= self.r_min - self.r_buf)
        )
        return pd, near_inner | near_outer

    def inverse(self, pose, z):
        mean = pose + z
        cov = jnp.broadcast_to(self.R, mean.shape + (1,))
        return mean, cov

    def pd(self, pose, lm_mean, lm_cov=None):
        r = jnp.abs(lm_mean[..., 0] - pose[..., 0])
        inside = (r <= self.r_max) & (r >= self.r_min)
        pd = jnp.where(inside, self.pd_const, 0.0)
        near_inner = inside & (
            (r >= self.r_max - self.r_buf) | (r <= self.r_min + self.r_buf)
        )
        near_outer = (~inside) & (
            (r <= self.r_max + self.r_buf) & (r >= self.r_min - self.r_buf)
        )
        return pd, near_inner | near_outer

    def clutter_intensity(self, z=None, n_z=None):
        return self.clutter

    def clutter_intensity_integral(self, n_z=None):
        return self.clutter * 2.0 * (self.r_max - self.r_min)
