"""SoA state containers for the particle filters.

The reference stores particles as shared-ptr object graphs
(``Particle<PoseType, DataType>`` with a per-particle ``GaussianMixture``
object, reference: Particle.hpp:47-150, GaussianMixture.hpp:51-224).  Here
the same information is a handful of fixed-shape arrays with an explicit
alive-mask, so that every filter phase is a dense batched program and
resampling is a single gather along the particle axis.

Landmark means and covariances are stored **plane-major**
(:mod:`rfs_slam_tpu.core.planar`): ``mean[D, P, M]`` and the packed symmetric
``cov[T, P, M]`` keep one full ``[P, M]`` plane per component, so every
phase is a fused elementwise program over planes.  Use
``mean_dense`` / ``cov_dense`` / ``from_dense`` only at boundaries (IO, tests).
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp

from rfs_slam_tpu.core import planar, struct


class GMState(struct.PyTreeNode):
    """Per-particle Gaussian-mixture map, padded to capacity M.

    Replaces ``GaussianMixture<Landmark>``'s
    ``std::vector<Gaussian{Landmark*, w, w_prev}>``
    (reference: GaussianMixture.hpp:60-64, 190-192).

    Attributes:
      mean:   [D, P, M]  Gaussian mean component planes.
      cov:    [T, P, M]  packed upper-triangle covariance planes,
                         T = D (D + 1) / 2 (planar.tri_index order).
      w:      [P, M]     current weights (GM-PHD intensity weights for the
                         RB-PHD filter; log-odds existence weights for
                         FastSLAM).
      w_prev: [P, M]     weight before the last update
                         (GaussianMixture.hpp:339-344; new Gaussians get 0).
      alive:  [P, M] bool slot-occupied mask.
    """

    mean: jax.Array
    cov: jax.Array
    w: jax.Array
    w_prev: jax.Array
    alive: jax.Array

    @classmethod
    def empty(cls, n_particles: int, capacity: int, dim: int, dtype=jnp.float32):
        eye = jnp.asarray(
            [1.0 if i == j else 0.0
             for i in range(dim) for j in range(i, dim)], dtype)
        return cls(
            mean=jnp.zeros((dim, n_particles, capacity), dtype),
            cov=jnp.broadcast_to(
                eye[:, None, None],
                (planar.tri_size(dim), n_particles, capacity),
            ),
            w=jnp.zeros((n_particles, capacity), dtype),
            w_prev=jnp.zeros((n_particles, capacity), dtype),
            alive=jnp.zeros((n_particles, capacity), bool),
        )

    @classmethod
    def from_dense(cls, mean, cov, w, w_prev=None, alive=None):
        """Build from ``mean[P, M, D]`` / ``cov[P, M, D, D]`` (boundary use)."""
        if w_prev is None:
            w_prev = jnp.zeros_like(w)
        if alive is None:
            alive = jnp.ones(w.shape, bool)
        return cls(mean=planar.pack_vec(mean), cov=planar.pack_sym(cov),
                   w=w, w_prev=w_prev, alive=alive)

    @property
    def mean_dense(self) -> jax.Array:
        """[P, M, D] view (boundary use only — a relayout copy)."""
        return planar.unpack_vec(self.mean)

    @property
    def cov_dense(self) -> jax.Array:
        """[P, M, D, D] view (boundary use only — a relayout copy)."""
        return planar.unpack_sym(self.cov, self.dim)

    @property
    def n_particles(self) -> int:
        return self.w.shape[0]

    @property
    def capacity(self) -> int:
        return self.w.shape[1]

    @property
    def dim(self) -> int:
        return self.mean.shape[0]

    def count(self) -> jax.Array:
        """Number of live Gaussians per particle, [P]."""
        return jnp.sum(self.alive, axis=-1)

    def gather_p(self, ancestors: jax.Array) -> "GMState":
        """Gather along the particle axis (resampling map copy)."""
        return GMState(
            mean=jnp.take(self.mean, ancestors, axis=1),
            cov=jnp.take(self.cov, ancestors, axis=1),
            w=jnp.take(self.w, ancestors, axis=0),
            w_prev=jnp.take(self.w_prev, ancestors, axis=0),
            alive=jnp.take(self.alive, ancestors, axis=0),
        )


class BirthCandidates(struct.PyTreeNode):
    """Masked state machine replacing the per-particle
    ``std::list<BirthGaussianCandidate>`` of the RB-PHD filter
    (reference: RBPHDFilter.hpp:171-178, 1000-1084) and the identical
    ``LandmarkCandidate`` list of FastSLAM (FastSLAM.hpp:160-167).

    Attributes:
      mean:      [D, P, C]  component planes.
      cov:       [T, P, C]  packed symmetric planes.
      n_support: [P, C] int32  supporting-measurement count.
      n_checks:  [P, C] int32  checks since creation.
      alive:     [P, C] bool
    """

    mean: jax.Array
    cov: jax.Array
    n_support: jax.Array
    n_checks: jax.Array
    alive: jax.Array

    @classmethod
    def empty(cls, n_particles: int, capacity: int, dim: int, dtype=jnp.float32):
        eye = jnp.asarray(
            [1.0 if i == j else 0.0
             for i in range(dim) for j in range(i, dim)], dtype)
        return cls(
            mean=jnp.zeros((dim, n_particles, capacity), dtype),
            cov=jnp.broadcast_to(
                eye[:, None, None],
                (planar.tri_size(dim), n_particles, capacity),
            ),
            n_support=jnp.zeros((n_particles, capacity), jnp.int32),
            n_checks=jnp.zeros((n_particles, capacity), jnp.int32),
            alive=jnp.zeros((n_particles, capacity), bool),
        )

    @property
    def capacity(self) -> int:
        return self.alive.shape[1]

    @property
    def dim(self) -> int:
        return self.mean.shape[0]

    def gather_p(self, ancestors: jax.Array) -> "BirthCandidates":
        return BirthCandidates(
            mean=jnp.take(self.mean, ancestors, axis=1),
            cov=jnp.take(self.cov, ancestors, axis=1),
            n_support=jnp.take(self.n_support, ancestors, axis=0),
            n_checks=jnp.take(self.n_checks, ancestors, axis=0),
            alive=jnp.take(self.alive, ancestors, axis=0),
        )


class ParticleState(struct.PyTreeNode):
    """The particle set (replaces ParticleFilter.hpp:48-208 bookkeeping).

    Attributes:
      pose:   [P, DX]  particle poses (x, y, theta for 2-D).
      log_w:  [P]      log importance weights.
      parent: [P] int32 ancestor index from the last resample
                        (Particle::setParentId, ParticleFilter.hpp:446-479).
      key:    [2]/typed jax.random key for this state's RNG stream.
    """

    pose: jax.Array
    log_w: jax.Array
    parent: jax.Array
    key: jax.Array

    @classmethod
    def init(cls, key: jax.Array, n_particles: int, pose0: Any, dtype=jnp.float32):
        pose0 = jnp.asarray(pose0, dtype)
        return cls(
            pose=jnp.broadcast_to(pose0, (n_particles,) + pose0.shape),
            log_w=jnp.zeros((n_particles,), dtype),
            parent=jnp.arange(n_particles, dtype=jnp.int32),
            key=key,
        )

    @property
    def n_particles(self) -> int:
        return self.pose.shape[0]
