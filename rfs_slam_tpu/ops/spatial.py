"""Spatial index — fixed-shape uniform-grid buckets.

Reference: ``SpatialIndexTree`` / ``SpatialIndexBox`` quadtree-octree
(SpatialIndexTree.hpp:49-585, SpatialIndexBox.hpp:50-200) with insert /
remove / box-query / closest-point.  The reference filters never use it
(SURVEY.md section 2.4) — it is an acceleration-structure library feature.

Mapping: pointer trees are hostile to XLA, so the index is a **uniform
grid with sorted buckets** — the idiomatic array equivalent:

* build  = cell-id per point + one argsort + searchsorted offsets (dense
  array work; rebuilds are cheap enough to replace insert/remove);
* box query = vectorized membership mask + top_k compaction (O(N) but one
  fused vector pass instead of a data-dependent tree traversal);
* nearest = ring search over grid buckets (exact when the true neighbor
  lies within ``n_rings`` cells; widen rings or shrink cells otherwise).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class GridIndex(NamedTuple):
    points: jax.Array      # [N, D]
    mask: jax.Array        # [N]
    origin: jax.Array      # [D]
    cell: jax.Array        # scalar cell edge
    res: tuple             # static grid resolution per dim
    order: jax.Array       # [N] point indices sorted by cell id
    starts: jax.Array      # [n_cells + 1] offsets into order


def _cell_ids(points, mask, origin, cell, res):
    D = points.shape[-1]
    ij = jnp.floor((points - origin) / cell).astype(jnp.int32)
    ij = jnp.clip(ij, 0, jnp.asarray(res, jnp.int32) - 1)
    flat = ij[..., 0]
    for d in range(1, D):
        flat = flat * res[d] + ij[..., d]
    n_cells = 1
    for r in res:
        n_cells *= r
    return jnp.where(mask, flat, n_cells), n_cells


def build(points: jax.Array, mask: jax.Array, origin, cell: float,
          res: tuple) -> GridIndex:
    """Build the index (replaces SpatialIndexTree::addData, :76-140)."""
    origin = jnp.asarray(origin, points.dtype)
    cell = jnp.asarray(cell, points.dtype)
    ids, n_cells = _cell_ids(points, mask, origin, cell, res)
    order = jnp.argsort(ids).astype(jnp.int32)
    sorted_ids = ids[order]
    starts = jnp.searchsorted(sorted_ids, jnp.arange(n_cells + 1))
    return GridIndex(points, mask, origin, cell, res, order, starts)


def query_box(idx: GridIndex, lo, hi, max_results: int):
    """Indices of points inside the axis-aligned box [lo, hi].

    Replaces SpatialIndexTree box query (:115-140).  Returns
    ``(indices [max_results] int32, valid [max_results] bool)``; results
    beyond ``max_results`` are dropped (count available via valid.sum()).
    """
    inside = (jnp.all(idx.points >= jnp.asarray(lo), axis=-1)
              & jnp.all(idx.points <= jnp.asarray(hi), axis=-1)
              & idx.mask)
    score = jnp.where(inside, -jnp.arange(idx.points.shape[0], dtype=jnp.float32),
                      -jnp.inf)
    _, top = jax.lax.top_k(score, max_results)
    valid = inside[top]
    return jnp.where(valid, top, -1).astype(jnp.int32), valid


def nearest(idx: GridIndex, q: jax.Array, n_rings: int = 2,
            bucket_cap: int = 32):
    """Closest indexed point to ``q`` (SpatialIndexTree closest-point).

    Exact if the nearest neighbor lies within ``n_rings`` grid cells of
    ``q``'s cell; returns ``(index, dist, found)`` with index = -1 when no
    candidate exists in the searched rings.  Batched via vmap over q.
    """
    D = q.shape[-1]
    res = idx.res
    qc = jnp.clip(jnp.floor((q - idx.origin) / idx.cell).astype(jnp.int32),
                  0, jnp.asarray(res, jnp.int32) - 1)
    # neighborhood cells (static (2r+1)^D enumeration)
    width = 2 * n_rings + 1
    offs = jnp.stack(jnp.meshgrid(
        *([jnp.arange(-n_rings, n_rings + 1)] * D), indexing="ij"),
        axis=-1).reshape(-1, D)
    cells = qc[None, :] + offs                        # [W^D, D]
    ok_cell = jnp.all((cells >= 0) & (cells < jnp.asarray(res)), axis=-1)
    flat = cells[..., 0]
    for d in range(1, D):
        flat = flat * res[d] + cells[..., d]
    flat = jnp.where(ok_cell, flat, 0)

    # gather bucket contents (bucket_cap per cell)
    s = idx.starts[flat]                              # [W^D]
    e = idx.starts[flat + 1]
    slots = jnp.arange(bucket_cap)
    gidx = s[:, None] + slots[None, :]                # [W^D, cap]
    in_bucket = (gidx < e[:, None]) & ok_cell[:, None]
    gidx = jnp.clip(gidx, 0, idx.order.shape[0] - 1)
    pt_idx = idx.order[gidx]
    cand = idx.points[pt_idx]                         # [W^D, cap, D]
    d2 = jnp.sum((cand - q) ** 2, axis=-1)
    d2 = jnp.where(in_bucket & idx.mask[pt_idx], d2, jnp.inf)
    flat_best = jnp.argmin(d2.reshape(-1))
    best_d2 = d2.reshape(-1)[flat_best]
    found = jnp.isfinite(best_d2)
    best_idx = jnp.where(found, pt_idx.reshape(-1)[flat_best], -1)
    return best_idx.astype(jnp.int32), jnp.sqrt(best_d2), found
