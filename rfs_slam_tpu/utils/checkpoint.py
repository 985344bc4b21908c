"""Checkpoint / resume for filter state.

The reference has NO checkpointing (SURVEY.md section 5 — runs restart from
scratch); this is a robustness addition for long runs.  A snapshot is the
step index plus every leaf of the filter-state pytree (particles, GM SoA
arrays, RNG key), stored in order with ``np.savez`` and written atomically
(tmp + rename), with ``keep``-deep rotation.  Restore rebuilds the pytree
from a template state, re-validating each leaf's shape and dtype.
"""

from __future__ import annotations

import os
import re

import jax
import numpy as np

_CKPT_RE = re.compile(r"^ckpt_(\d+)\.npz$")


def save(ckpt_dir: str, step: int, state, keep: int = 3) -> str:
    """Write an atomic snapshot; returns the file path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    leaves = jax.tree_util.tree_leaves(state)
    path = os.path.join(ckpt_dir, f"ckpt_{step}.npz")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, step=np.int64(step),
                 **{f"leaf_{i}": np.asarray(x) for i, x in enumerate(leaves)})
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _rotate(ckpt_dir, keep)
    return path


def latest_step(ckpt_dir: str) -> int | None:
    """Step index of the newest snapshot, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for n in os.listdir(ckpt_dir)
             if (m := _CKPT_RE.match(n))]
    return max(steps) if steps else None


def restore(ckpt_dir: str, template_state, step: int | None = None):
    """Load a snapshot into the structure of ``template_state``.

    Returns ``(step, state)``.  Raises FileNotFoundError if absent and
    ValueError if the snapshot does not match the template.
    """
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"ckpt_{step}.npz")
    t_leaves, treedef = jax.tree_util.tree_flatten(template_state)
    with np.load(path) as data:
        n = len(data.files) - 1
        if n != len(t_leaves):
            raise ValueError(f"{path}: {n} leaves, template has "
                             f"{len(t_leaves)}")
        leaves = []
        for i, t in enumerate(t_leaves):
            v = data[f"leaf_{i}"]
            if v.shape != np.shape(t):
                raise ValueError(f"{path}: leaf {i} has shape {v.shape}, "
                                 f"template {np.shape(t)}")
            leaves.append(jax.numpy.asarray(v, getattr(t, "dtype", None)))
        saved_step = int(data["step"])
    return saved_step, jax.tree_util.tree_unflatten(treedef, leaves)


def _rotate(ckpt_dir: str, keep: int) -> None:
    entries = sorted(
        (int(m.group(1)), n) for n in os.listdir(ckpt_dir)
        if (m := _CKPT_RE.match(n)))
    for _, name in entries[:-keep] if keep > 0 else []:
        os.unlink(os.path.join(ckpt_dir, name))
