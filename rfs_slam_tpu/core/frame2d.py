"""2-D coordinate frame composition with covariance transport.

Reference: ``Frame2d`` (Frame.hpp:40-113, src/Frame.cpp) — SE(2) frame
composition (operator*), point transforms, and expression of a frame
relative to the base frame, carrying pose covariance through the
composition Jacobians.  Unused by the reference filters (analysis aid);
provided batched for parity.

A frame is ``(pose [..., 3], cov [..., 3, 3])`` with pose = (x, y, theta).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from rfs_slam_tpu.core import gaussian


def compose(pose_a, cov_a, pose_b, cov_b):
    """Frame composition c = a * b (b expressed in a's frame).

    Covariance: J_a cov_a J_a^T + J_b cov_b J_b^T with the standard SE(2)
    composition Jacobians.  Batched over leading dims.
    """
    xa, ya, ta = pose_a[..., 0], pose_a[..., 1], pose_a[..., 2]
    xb, yb, tb = pose_b[..., 0], pose_b[..., 1], pose_b[..., 2]
    c, s = jnp.cos(ta), jnp.sin(ta)
    xc = xa + c * xb - s * yb
    yc = ya + s * xb + c * yb
    tc = gaussian.wrap_angle(ta + tb)
    pose_c = jnp.stack([xc, yc, tc], axis=-1)

    zero = jnp.zeros_like(xa)
    one = jnp.ones_like(xa)
    # d(pose_c)/d(pose_a)
    Ja = jnp.stack([
        jnp.stack([one, zero, -s * xb - c * yb], axis=-1),
        jnp.stack([zero, one, c * xb - s * yb], axis=-1),
        jnp.stack([zero, zero, one], axis=-1),
    ], axis=-2)
    # d(pose_c)/d(pose_b)
    Jb = jnp.stack([
        jnp.stack([c, -s, zero], axis=-1),
        jnp.stack([s, c, zero], axis=-1),
        jnp.stack([zero, zero, one], axis=-1),
    ], axis=-2)
    cov_c = gaussian.sandwich(Ja, cov_a) + gaussian.sandwich(Jb, cov_b)
    return pose_c, cov_c


def inverse(pose, cov):
    """Frame inverse: a * inv(a) = identity, with covariance transport."""
    x, y, t = pose[..., 0], pose[..., 1], pose[..., 2]
    c, s = jnp.cos(t), jnp.sin(t)
    xi = -(c * x + s * y)
    yi = s * x - c * y
    pose_i = jnp.stack([xi, yi, -t], axis=-1)
    zero = jnp.zeros_like(x)
    J = jnp.stack([
        jnp.stack([-c, -s, yi], axis=-1),
        jnp.stack([s, -c, -xi], axis=-1),
        jnp.stack([zero, zero, -jnp.ones_like(x)], axis=-1),
    ], axis=-2)
    return pose_i, gaussian.sandwich(J, cov)


def transform_point(pose, point):
    """Express ``point`` (given in the frame of ``pose``) in the base frame."""
    c, s = jnp.cos(pose[..., 2]), jnp.sin(pose[..., 2])
    x = pose[..., 0] + c * point[..., 0] - s * point[..., 1]
    y = pose[..., 1] + s * point[..., 0] + c * point[..., 1]
    return jnp.stack([x, y], axis=-1)


def chain_to_base(poses, covs):
    """Compose a chain of relative frames into base-frame poses.

    ``poses [T, 3]`` where pose[t] is frame t expressed in frame t-1
    (pose[0] relative to base).  Returns absolute ``(poses [T, 3],
    covs [T, 3, 3])`` — the getRelToBaseFrame chain (Frame.hpp:86-113) as
    an O(T) scan.
    """
    def step(carry, x):
        p, c = compose(carry[0], carry[1], x[0], x[1])
        return (p, c), (p, c)

    init = (jnp.zeros(3, poses.dtype), jnp.zeros((3, 3), poses.dtype))
    _, (abs_p, abs_c) = jax.lax.scan(step, init, (poses, covs))
    return abs_p, abs_c
