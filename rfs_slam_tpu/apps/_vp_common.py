"""Shared scan driver of the apps.

Runs a whole-run ``lax.scan`` in one dispatch, or, when checkpointing is
asked for, in fixed-size chunks with a host round-trip between chunks:
after each chunk the filter state is
snapshotted (utils/checkpoint.py) and the chunk's per-frame outputs are
persisted, so an interrupted run resumes bit-identically (chunking does not
change the math — the RNG key lives in the filter state).  The reference has
no checkpointing (SURVEY.md section 5): its 69.9k-message event loop
restarts from scratch.
"""

from __future__ import annotations

import os
import time
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from rfs_slam_tpu.utils import checkpoint


class RunSummary(NamedTuple):
    """What a 2-D sim app's ``main()`` returns."""

    steps: int
    wall_s: float             # including compilation
    median_pose_err_m: float  # best particle, steps >= 150
    finite: bool              # every logged float output is finite


def all_finite(outs) -> bool:
    """True when every floating-point array in ``outs`` is finite."""
    return all(bool(np.isfinite(o).all()) for o in outs
               if np.issubdtype(np.asarray(o).dtype, np.floating))


def chunked_scan(scan_all, state, inputs_np, ckpt_dir: str | None = None,
                 ckpt_every: int = 0, resume: bool = False,
                 progress: bool = True, resume_at: int | None = None,
                 ckpt_keep: int = 3, reseed: int | None = None):
    """Drive ``scan_all(state, chunk_inputs) -> (state, outs)`` over chunks.

    Args:
      scan_all: jitted whole-chunk scan (state, tuple-of-[C, ...] inputs).
      state: initial filter state (replaced by the restored one on resume).
      inputs_np: list of [F, ...] numpy per-frame input arrays.
      ckpt_dir/ckpt_every/resume: snapshot controls; ``ckpt_every <= 0``
        runs one monolithic chunk.
      resume_at: resume from the snapshot at this exact frame index instead
        of the newest one (counterfactual probes from a mid-run state).
      ckpt_keep: snapshot rotation depth (0 = keep all).
      reseed: if set, fold this value into the restored particle RNG key —
        a counterfactual resume that replays the remaining stream under a
        different random sequence from the identical mid-run state.

    Returns:
      (final_state, outs, wall_s) with ``outs`` the per-frame output pytree
      concatenated over all F frames (including reloaded pre-resume chunks).
    """
    F = inputs_np[0].shape[0]
    start = 0
    if (resume or resume_at is not None) and ckpt_dir is not None:
        done = (resume_at if resume_at is not None
                else checkpoint.latest_step(ckpt_dir))
        if done is not None:
            start, state = checkpoint.restore(ckpt_dir, state, step=resume_at)
            print(f"resumed from frame {start} ({ckpt_dir})")
            if reseed is not None:
                p = state.particles
                state = state.replace(particles=p.replace(
                    key=jax.random.fold_in(p.key, reseed)))
                print(f"reseeded particle RNG (fold_in {reseed})")

    C = ckpt_every if ckpt_every and ckpt_every > 0 else F
    outs_chunks = _load_out_chunks(ckpt_dir, start) if start > 0 else []
    t0 = time.time()
    f = start
    while f < F:
        c = min(C, F - f)
        chunk = tuple(jnp.asarray(a[f:f + c]) for a in inputs_np)
        state, outs = scan_all(state, chunk)
        outs = jax.tree_util.tree_map(np.asarray, outs)
        f += c
        if ckpt_dir is not None:
            np.savez(os.path.join(ckpt_dir, f"outs_{f - c:06d}_{f:06d}.npz"),
                     **{str(i): o for i, o in enumerate(outs)})
            checkpoint.save(ckpt_dir, f, state, keep=ckpt_keep)
        outs_chunks.append(tuple(outs))
        if progress and C < F:
            print(f"  frame {f}/{F} ({time.time() - t0:.0f}s)", flush=True)
    wall = time.time() - t0
    outs = jax.tree_util.tree_map(
        lambda *xs: np.concatenate(xs, axis=0), *outs_chunks)
    return state, outs, wall


def _load_out_chunks(ckpt_dir: str, upto: int):
    """Reload persisted per-chunk outputs covering frames [0, upto)."""
    chunks = []
    covered = 0
    names = sorted(n for n in os.listdir(ckpt_dir)
                   if n.startswith("outs_") and n.endswith(".npz"))
    for n in names:
        f0, f1 = (int(x) for x in n[5:-4].split("_"))
        if f0 == covered and f1 <= upto:
            with np.load(os.path.join(ckpt_dir, n)) as zz:
                chunks.append(tuple(zz[str(i)] for i in range(len(zz.files))))
            covered = f1
    if covered != upto:
        raise FileNotFoundError(
            f"output chunks cover frames [0, {covered}), need [0, {upto}); "
            f"delete {ckpt_dir} to restart")
    return chunks


def add_ckpt_args(ap) -> None:
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (enables chunked snapshots)")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="snapshot every N lidar frames")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the newest snapshot in --ckpt-dir")
    ap.add_argument("--resume-at", type=int, default=None,
                    help="resume from the snapshot at this exact frame")
    ap.add_argument("--ckpt-keep", type=int, default=3,
                    help="snapshot rotation depth (0 = keep all)")
    ap.add_argument("--reseed", type=int, default=None,
                    help="fold this value into the restored RNG key "
                         "(counterfactual resume probe)")
