"""Process (motion) models as batched pure functions.

Covers the reference's L1 process-model family (ProcessModel.hpp:53-225,
ProcessModel_Odometry1D/2D.cpp, ProcessModel_Ackerman2D.cpp): every ``step``
maps ``(..., DX)`` pose batches through the deterministic motion model, and
``sample`` adds input and/or additive white Gaussian noise exactly like
``ProcessModel::sample`` (ProcessModel.hpp:125-150):

* ``use_input_noise``: sample the input from N(u, U) before stepping.
* ``use_model_noise``: add chol(Q) @ N(0, I) to the stepped pose.

All functions broadcast over arbitrary leading batch axes; the particle axis
is just the leading dimension.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from rfs_slam_tpu.core import gaussian, struct


def _maybe_sample_input(key, u, use_input_noise, input_cov):
    """Sample input noise; ``use_input_noise`` may be a traced bool (the
    Victoria Park event loop toggles it per message,
    rbphdslam_VictoriaPark.cpp:512-517)."""
    if input_cov is None or (isinstance(use_input_noise, bool)
                             and not use_input_noise):
        return u
    d = u.shape[-1]
    u_s = gaussian.sample(key, u, input_cov)
    if isinstance(use_input_noise, bool):
        return u_s
    return jnp.where(jnp.asarray(use_input_noise), u_s, u)


class Odometry2D(struct.PyTreeNode):
    """SE(2) odometry model (reference: ProcessModel_Odometry2D.cpp:41-89).

    The pose is ``[x, y, theta]``; the input is a body-frame displacement
    ``[dx, dy, dtheta]``.  The step composes

        p_k = p_{k-1} + C(theta)^T [dx, dy],   theta_k = wrap(theta + dtheta)

    where ``C(theta) = [[c, s], [-s, c]]`` so that ``C^T`` is the standard
    rotation matrix — matching the reference's
    ``p_k = p_km + C_km^T dp`` / ``C_k = C_u C_km`` composition.

    Attributes:
      Q: [3, 3] additive white-noise covariance (already scaled by the app,
         reference apps use Q * dt^2 * inflation — rbphdslam2dSim.cpp:450-456).
    """

    Q: jax.Array

    def step(self, pose: jax.Array, u: jax.Array, dt) -> jax.Array:
        theta = pose[..., 2]
        c, s = jnp.cos(theta), jnp.sin(theta)
        dx, dy, dth = u[..., 0], u[..., 1], u[..., 2]
        x = pose[..., 0] + c * dx - s * dy
        y = pose[..., 1] + s * dx + c * dy
        th = gaussian.wrap_angle(theta + dth)
        return jnp.stack([x, y, th], axis=-1)

    def sample(
        self,
        key: jax.Array,
        pose: jax.Array,
        u: jax.Array,
        dt,
        use_model_noise: bool = True,
        use_input_noise: bool = False,
        input_cov: jax.Array | None = None,
    ) -> jax.Array:
        k_in, k_add = jax.random.split(key)
        # broadcast u over the pose batch so input noise is drawn
        # per-particle (ProcessModel::sample draws per call/particle)
        u = jnp.broadcast_to(u, pose.shape[:-1] + u.shape[-1:])
        u = _maybe_sample_input(k_in, u, use_input_noise, input_cov)
        out = self.step(pose, u, dt)
        if use_model_noise:
            out = gaussian.sample(k_add, out, self.Q)
            out = out.at[..., 2].set(gaussian.wrap_angle(out[..., 2]))
        return out


class Odometry1D(struct.PyTreeNode):
    """1-D odometry model (reference: ProcessModel_Odometry1D.cpp)."""

    Q: jax.Array  # [1, 1]

    def step(self, pose: jax.Array, u: jax.Array, dt) -> jax.Array:
        return pose + u

    def sample(self, key, pose, u, dt, use_model_noise=True, use_input_noise=False,
               input_cov=None):
        k_in, k_add = jax.random.split(key)
        # broadcast u over the pose batch so input noise is drawn
        # per-particle (ProcessModel::sample draws per call/particle)
        u = jnp.broadcast_to(u, pose.shape[:-1] + u.shape[-1:])
        u = _maybe_sample_input(k_in, u, use_input_noise, input_cov)
        out = self.step(pose, u, dt)
        if use_model_noise:
            out = gaussian.sample(k_add, out, self.Q)
        return out


class Ackerman2D(struct.PyTreeNode):
    """Ackerman-steered vehicle model (reference: ProcessModel_Ackerman2D.cpp:49-77).

    Input ``[v, r]`` = rear-wheel speed and steering angle; geometry per the
    Victoria Park vehicle: rear-axle-to-encoder offset ``h``, wheelbase ``l``,
    point-of-interest (sensor) offset ``(dx, dy)``.

    Attributes:
      Q: [3, 3] additive white-noise covariance.
      h, l, dx, dy: scalar Ackerman geometry
                    (MotionModel_Ackerman2d::setAckermanParams).
    """

    Q: jax.Array
    h: float = struct.field(pytree_node=False, default=0.76)
    l: float = struct.field(pytree_node=False, default=2.83)
    dx: float = struct.field(pytree_node=False, default=0.5)
    dy: float = struct.field(pytree_node=False, default=0.5)

    def step(self, pose: jax.Array, u: jax.Array, dt) -> jax.Array:
        v, r = u[..., 0], u[..., 1]
        theta = pose[..., 2]
        c, s = jnp.cos(theta), jnp.sin(theta)
        tan_r = jnp.tan(r)
        v = v / (1.0 - tan_r * self.h / self.l)
        dxs = dt * (v * c - v / self.l * tan_r * (self.dx * s + self.dy * c))
        dys = dt * (v * s + v / self.l * tan_r * (self.dx * c - self.dy * s))
        dth = dt * v / self.l * tan_r
        th = theta + dth
        # single-branch wrap, exactly as the reference (+-2pi once)
        th = jnp.where(th > jnp.pi, th - 2 * jnp.pi, th)
        th = jnp.where(th < -jnp.pi, th + 2 * jnp.pi, th)
        return jnp.stack([pose[..., 0] + dxs, pose[..., 1] + dys, th], axis=-1)

    def sample(self, key, pose, u, dt, use_model_noise=True, use_input_noise=False,
               input_cov=None):
        k_in, k_add = jax.random.split(key)
        # broadcast u over the pose batch so input noise is drawn
        # per-particle (ProcessModel::sample draws per call/particle)
        u = jnp.broadcast_to(u, pose.shape[:-1] + u.shape[-1:])
        u = _maybe_sample_input(k_in, u, use_input_noise, input_cov)
        out = self.step(pose, u, dt)
        if use_model_noise:
            out = gaussian.sample(k_add, out, self.Q)
        return out


class StaticLandmark(struct.PyTreeNode):
    """Landmark process model: identity mean, covariance grows by Q.

    Reference: ``StaticProcessModel::step`` adds Q to the covariance
    (ProcessModel.hpp:195-219); apps pre-scale Q by dt^2
    (rbphdslam2dSim.cpp:458-462).

    Attributes:
      Q: [D, D] covariance growth per step (zero => landmarks truly static).
      per_dt2: scale Q by dt^2 at step time (Victoria Park wiring sets the
        noise per message interval, rbphdslam_VictoriaPark.cpp:508-510); the
        sim apps pre-scale Q instead.
    """

    Q: jax.Array
    per_dt2: bool = struct.field(pytree_node=False, default=False)

    def static_step(self, mean: jax.Array, cov: jax.Array, dt):
        q = self.Q * (dt * dt) if self.per_dt2 else self.Q
        return mean, cov + q

    def static_step_p(self, mean: jax.Array, cov: jax.Array, dt):
        """Plane-layout step: ``cov[T, ...]`` packed (see core.planar)."""
        from rfs_slam_tpu.core import planar

        q = self.Q * (dt * dt) if self.per_dt2 else self.Q
        qp = planar.pack_sym(jnp.asarray(q))
        return mean, cov + qp.reshape(qp.shape + (1,) * (cov.ndim - 1))
