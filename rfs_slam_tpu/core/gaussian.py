"""Batched Gaussian toolkit — the RandomVec equivalent.

The reference represents every uncertain quantity as a ``RandomVec<nDim>``
object caching its covariance inverse / determinant / Cholesky factor
(reference: RandomVec.hpp:64-525).  Here the same functionality is provided as
batched pure functions over ``(..., D)`` mean and ``(..., D, D)`` covariance
arrays.  D is tiny (1-3), so inverses and determinants are computed with
closed-form minors rather than LAPACK calls, which fuse into the surrounding
elementwise work instead of forcing a batched linalg kernel.  Every small
matrix product runs at full float32 precision (``Precision.HIGHEST``).

Semantics matched to the reference:

* ``eval_likelihood`` = exp(-md2/2) / sqrt((2*pi)^D * det(S)) with the
  NaN -> 0 guard of RandomVec.hpp:424-425 (implemented as a finite-mask).
* ``mahalanobis2`` uses the covariance inverse directly
  (RandomVec.hpp:387-407).
* ``sample`` draws x + chol(S) @ N(0, I) (RandomVec.hpp:457-496); the global
  boost::mt19937 of the reference (RandomVec.hpp:527-533) is replaced by
  threaded ``jax.random`` keys, so parity is distributional, not bitwise.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

LOG_2PI = 1.8378770664093453

# Linear-domain floor standing in for the reference's
# std::numeric_limits<double>::denorm_min() particle-weight floor
# (RBPHDFilter.hpp:570, 743). float32-safe.
TINY = 1e-35
# Floor for squared-range Jacobian denominators (range-bearing-style models):
# keeps H finite for a landmark exactly at the sensor (dead slots + origin
# pose).  Shared by models/measurement.py and models/victoria_park.py so the
# clamp cannot drift between models.
R2_TINY = 1e-24


def det(S: jax.Array) -> jax.Array:
    """Determinant of batched tiny SPD matrices ``(..., D, D)`` (D in 1..3)."""
    d = S.shape[-1]
    if d == 1:
        return S[..., 0, 0]
    if d == 2:
        return S[..., 0, 0] * S[..., 1, 1] - S[..., 0, 1] * S[..., 1, 0]
    if d == 3:
        a, b, c = S[..., 0, 0], S[..., 0, 1], S[..., 0, 2]
        e, f, g = S[..., 1, 0], S[..., 1, 1], S[..., 1, 2]
        h, i, j = S[..., 2, 0], S[..., 2, 1], S[..., 2, 2]
        return a * (f * j - g * i) - b * (e * j - g * h) + c * (e * i - f * h)
    return jnp.linalg.det(S)


def inv(S: jax.Array) -> jax.Array:
    """Inverse of batched tiny matrices via adjugate (D in 1..3)."""
    d = S.shape[-1]
    if d == 1:
        return 1.0 / S
    if d == 2:
        dt = det(S)[..., None, None]
        adj = jnp.stack(
            [
                jnp.stack([S[..., 1, 1], -S[..., 0, 1]], axis=-1),
                jnp.stack([-S[..., 1, 0], S[..., 0, 0]], axis=-1),
            ],
            axis=-2,
        )
        return adj / dt
    if d == 3:
        dt = det(S)[..., None, None]
        m = S
        c00 = m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1]
        c01 = m[..., 0, 2] * m[..., 2, 1] - m[..., 0, 1] * m[..., 2, 2]
        c02 = m[..., 0, 1] * m[..., 1, 2] - m[..., 0, 2] * m[..., 1, 1]
        c10 = m[..., 1, 2] * m[..., 2, 0] - m[..., 1, 0] * m[..., 2, 2]
        c11 = m[..., 0, 0] * m[..., 2, 2] - m[..., 0, 2] * m[..., 2, 0]
        c12 = m[..., 0, 2] * m[..., 1, 0] - m[..., 0, 0] * m[..., 1, 2]
        c20 = m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0]
        c21 = m[..., 0, 1] * m[..., 2, 0] - m[..., 0, 0] * m[..., 2, 1]
        c22 = m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
        adj = jnp.stack(
            [
                jnp.stack([c00, c01, c02], axis=-1),
                jnp.stack([c10, c11, c12], axis=-1),
                jnp.stack([c20, c21, c22], axis=-1),
            ],
            axis=-2,
        )
        return adj / dt
    return jnp.linalg.inv(S)


def chol(S: jax.Array) -> jax.Array:
    """Lower Cholesky factor of batched tiny SPD matrices (D in 1..3)."""
    d = S.shape[-1]
    if d == 1:
        return jnp.sqrt(S)
    if d == 2:
        l00 = jnp.sqrt(S[..., 0, 0])
        l10 = S[..., 1, 0] / l00
        l11 = jnp.sqrt(jnp.maximum(S[..., 1, 1] - l10 * l10, 0.0))
        z = jnp.zeros_like(l00)
        return jnp.stack(
            [
                jnp.stack([l00, z], axis=-1),
                jnp.stack([l10, l11], axis=-1),
            ],
            axis=-2,
        )
    if d == 3:
        l00 = jnp.sqrt(S[..., 0, 0])
        l10 = S[..., 1, 0] / l00
        l20 = S[..., 2, 0] / l00
        l11 = jnp.sqrt(jnp.maximum(S[..., 1, 1] - l10 * l10, 0.0))
        l21 = (S[..., 2, 1] - l20 * l10) / l11
        l22 = jnp.sqrt(jnp.maximum(S[..., 2, 2] - l20 * l20 - l21 * l21, 0.0))
        z = jnp.zeros_like(l00)
        return jnp.stack(
            [
                jnp.stack([l00, z, z], axis=-1),
                jnp.stack([l10, l11, z], axis=-1),
                jnp.stack([l20, l21, l22], axis=-1),
            ],
            axis=-2,
        )
    return jnp.linalg.cholesky(S)


def quad_form(Sinv: jax.Array, e: jax.Array) -> jax.Array:
    """e^T Sinv e for batched ``(..., D, D)`` and ``(..., D)``."""
    return jnp.einsum("...i,...ij,...j->...", e, Sinv, e,
                      precision=jax.lax.Precision.HIGHEST)


def mahalanobis2(mean: jax.Array, cov: jax.Array, x: jax.Array) -> jax.Array:
    """Squared Mahalanobis distance of x from N(mean, cov).

    Reference: RandomVec.hpp:387-407.
    """
    return quad_form(inv(cov), x - mean)


def eval_likelihood(mean: jax.Array, cov: jax.Array, x: jax.Array):
    """Gaussian pdf value at ``x`` plus the squared Mahalanobis distance.

    Returns ``(likelihood, md2)`` matching
    ``RandomVec::evalGaussianLikelihood`` (RandomVec.hpp:415-451) including
    its not-finite -> 0 guard.
    """
    d = mean.shape[-1]
    md2 = mahalanobis2(mean, cov, x)
    norm = jnp.sqrt(jnp.power(2.0 * jnp.pi, d) * det(cov))
    lik = jnp.exp(-0.5 * md2) / norm
    lik = jnp.where(jnp.isfinite(lik), lik, 0.0)
    return lik, md2


def log_likelihood(mean: jax.Array, cov: jax.Array, x: jax.Array):
    """Log Gaussian pdf at x and the squared Mahalanobis distance."""
    d = mean.shape[-1]
    md2 = mahalanobis2(mean, cov, x)
    logdet = jnp.log(det(cov))
    logp = -0.5 * (md2 + logdet + d * LOG_2PI)
    return logp, md2


def sample(key: jax.Array, mean: jax.Array, cov: jax.Array) -> jax.Array:
    """Sample from batched N(mean, cov) via the Cholesky factor.

    Reference: RandomVec.hpp:457-496 (chol(S) @ N(0, I) + mean).
    """
    n = jax.random.normal(key, mean.shape, dtype=mean.dtype)
    return mean + jnp.einsum("...ij,...j->...i", chol(cov), n,
                             precision=jax.lax.Precision.HIGHEST)


def sandwich(J: jax.Array, S: jax.Array) -> jax.Array:
    """J S J^T for batched ``(..., R, D)`` and ``(..., D, D)``."""
    hi = jax.lax.Precision.HIGHEST
    return jnp.matmul(jnp.matmul(J, S, precision=hi),
                      jnp.swapaxes(J, -1, -2), precision=hi)


def symmetrize(S: jax.Array) -> jax.Array:
    """(S + S^T)/2 — covariance symmetrization as in KalmanFilter.hpp:242."""
    return 0.5 * (S + jnp.swapaxes(S, -1, -2))


def wrap_angle(a: jax.Array) -> jax.Array:
    """Wrap angles to (-pi, pi].

    Replaces the reference's while-subtract loops (e.g.
    MeasurementModel_RngBrg.cpp:96-97, KalmanFilter_RngBrg.cpp:58-62) with a
    branch-free formulation safe inside jit.
    """
    return a - 2.0 * jnp.pi * jnp.round(a / (2.0 * jnp.pi))
