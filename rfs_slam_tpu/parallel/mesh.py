"""Device mesh + particle-axis sharding.

The reference parallelizes over particles with OpenMP threads in shared
memory (reference: RBPHDFilter.hpp:469-520, CMakeLists.txt:38-46).  The
equivalent here shards the particle axis of every state array over a 1-D
``jax.sharding.Mesh``; all per-particle phases are embarrassingly parallel,
and XLA GSPMD inserts the only two collectives the algorithm needs:

* weight normalization / ESS: an all-reduce over the particle axis
  (psum of exp(log_w) terms inside logsumexp);
* resampling: the ancestor gather (all-to-all) when particles migrate
  between shards (ParticleFilter.hpp:446-479's deep copies).

Multi-process: call :func:`init_distributed` first (jax.distributed), then
the same code runs with the collectives spanning every process's devices.
"""

from __future__ import annotations

from typing import Any

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

PARTICLE_AXIS = "particles"
MAP_AXIS = "map"


def init_distributed(coordinator: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Initialize the multi-host runtime (no-op if single-process)."""
    if num_processes and num_processes > 1:
        jax.distributed.initialize(coordinator, num_processes, process_id)


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh over the particle axis."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (PARTICLE_AXIS,))


def particle_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P(PARTICLE_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def state_shardings(tree: Any, mesh: Mesh, n_particles: int):
    """Per-leaf shardings: the particle axis shards, everything else replicates.

    Plane-major map arrays (``[D, P, M]`` / ``[T, P, M]``, see core.planar)
    carry the particle axis second; everything else (poses, weights, masks)
    carries it first.  Works for RBPHDState / FastSLAM state / plain pytrees.
    """
    shard0 = particle_sharding(mesh)
    shard1 = NamedSharding(mesh, P(None, PARTICLE_AXIS))
    repl = replicated(mesh)

    def spec(leaf):
        if not hasattr(leaf, "ndim"):
            return repl
        if leaf.ndim >= 1 and leaf.shape[0] == n_particles:
            return shard0
        if leaf.ndim >= 2 and leaf.shape[1] == n_particles:
            return shard1
        return repl

    return jax.tree_util.tree_map(spec, tree)


def shard_state(tree: Any, mesh: Mesh, n_particles: int):
    """Place a state pytree on the mesh with particle-axis sharding."""
    shardings = state_shardings(tree, mesh, n_particles)
    return jax.tree_util.tree_map(jax.device_put, tree, shardings)


def make_mesh_2d(n_particle_shards: int, n_map_shards: int,
                 devices=None) -> Mesh:
    """2-D mesh: particle axis x landmark (map-block) axis.

    Map-block parallelism is the structural analog of sequence/context
    parallelism for this workload (SURVEY.md section 2.8 row 4): a
    particle's Gaussian mixture (the M axis of the [D, P, M] planes and the
    [P, Z, M] weight table) grows unboundedly on large datasets; sharding M
    over a second mesh axis splits each particle's map across devices.  The
    cross-M reductions of the filter (weight-table column sums, GM intensity
    sums in importance weighting, top-k new-Gaussian compaction) become
    XLA GSPMD collectives over this axis.
    """
    if devices is None:
        devices = jax.devices()
    n = n_particle_shards * n_map_shards
    arr = np.asarray(devices[:n]).reshape(n_particle_shards, n_map_shards)
    return Mesh(arr, (PARTICLE_AXIS, MAP_AXIS))


def state_shardings_2d(tree: Any, mesh: Mesh, n_particles: int,
                       map_capacity: int):
    """Per-leaf shardings on a 2-D mesh: particle axis + landmark axis.

    Plane-major map arrays ``[D, P, M]`` shard as (None, particles, map);
    per-particle vectors ``[P, M]`` as (particles, map); everything else
    falls back to particle-only or replicated.  Measurement-axis arrays
    (``[Zc, ...]``) replicate.
    """
    repl = NamedSharding(mesh, P())

    def spec(leaf):
        if not hasattr(leaf, "ndim"):
            return repl
        shp = leaf.shape
        if (leaf.ndim >= 3 and shp[1] == n_particles
                and shp[2] == map_capacity):
            return NamedSharding(mesh, P(None, PARTICLE_AXIS, MAP_AXIS))
        if leaf.ndim >= 2 and shp[0] == n_particles and shp[1] == map_capacity:
            return NamedSharding(mesh, P(PARTICLE_AXIS, MAP_AXIS))
        if leaf.ndim >= 2 and shp[1] == n_particles:
            return NamedSharding(mesh, P(None, PARTICLE_AXIS))
        if leaf.ndim >= 1 and shp[0] == n_particles:
            return NamedSharding(mesh, P(PARTICLE_AXIS))
        return repl

    return jax.tree_util.tree_map(spec, tree)
