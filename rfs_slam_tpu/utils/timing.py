"""Per-phase timing report — the TimingInfo equivalent.

Reference: per-phase boost cpu_timers in the filters (RBPHDFilter.hpp:278-284,
Timer.hpp:42-75) exposed via ``getTimingInfo()`` (:1219-1232) and logged to
``timing.dat`` (rbphdslam2dSim.cpp:654-732).

On the device the whole timestep is ONE jitted program, so phases cannot be
timed inside the production scan without breaking fusion.  Instead
:func:`profile_phases` times each phase as its own jitted call
(``block_until_ready`` wall clocks, warm-cache, ``reps`` repetitions) —
an explicit profiling mode, like the reference's gperftools builds
(CMakeLists.txt:60-82).  For deeper analysis use ``jax.profiler`` traces.
"""

from __future__ import annotations

import time

import jax


class PhaseTimer:
    """Accumulates wall-clock AND host-CPU time per named phase.

    ``cpu`` is this process's CPU time (``time.process_time``): for
    device-bound phases it measures dispatch/host overhead, NOT device work
    — the honest device-side analog of the reference's boost cpu_timer columns
    (Timer.hpp:42-75), documented as such in timing.dat.
    """

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.cpu_totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    def time(self, name: str, fn, *args, **kwargs):
        c0 = time.process_time()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        out = jax.block_until_ready(out)
        dt = time.perf_counter() - t0
        dc = time.process_time() - c0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.cpu_totals[name] = self.cpu_totals.get(name, 0.0) + dc
        self.counts[name] = self.counts.get(name, 0) + 1
        return out

    def report(self) -> dict[str, tuple[float, float]]:
        """{phase: (wall_s, host_cpu_s)} — feed to io.logs.write_timing."""
        return {k: (v, self.cpu_totals[k]) for k, v in self.totals.items()}

    def table(self) -> str:
        w = max((len(k) for k in self.totals), default=8)
        lines = [f"{'Phase':<{w}}  {'Wall (s)':>10}  {'HostCPU (s)':>11}  "
                 f"{'Calls':>6}"]
        for k, v in self.totals.items():
            lines.append(f"{k:<{w}}  {v:>10.4f}  {self.cpu_totals[k]:>11.4f}"
                         f"  {self.counts[k]:>6}")
        return "\n".join(lines)


def profile_phases(filt, state, u, dt, z, z_mask, reps: int = 10):
    """Time the reference's seven RB-PHD phases separately.

    Phase set and naming per ``RBPHDFilter::TimingInfo``
    (RBPHDFilter.hpp:152-167): predict, mapUpdate, mapUpdate_kf,
    particleWeighting, mapMerge, mapPrune, particleResample.  Each phase is
    its own jitted call on the phase-boundary methods the production
    ``update`` composes (filters/rbphd.py:_map_update / _importance_weights
    / _resample_phase), so the numbers reflect per-phase device cost without
    de-fusing the production step.

    Returns a PhaseTimer after ``reps`` warm iterations; the first
    (compile) call of each phase is excluded.
    """
    import jax.numpy as jnp

    from rfs_slam_tpu.ops import gm as gm_ops
    from rfs_slam_tpu.ops.ekf import correct_all

    cfg = filt.cfg
    meas = filt.meas
    predict = jax.jit(lambda s: filt.predict(s, u, dt))
    kf = jax.jit(lambda s: correct_all(
        meas, filt.gates, s.particles.pose, s.gm.mean, s.gm.cov, z))
    map_update = jax.jit(lambda s: filt._map_update(s, z, z_mask, meas))
    weighting = jax.jit(lambda s, gmf, lw, cz: filt._importance_weights(
        lw, s.particles.pose, gmf, z, z_mask, cz, jnp.sum(z_mask), meas))
    merge = jax.jit(lambda g: gm_ops.merge(
        g, cfg.merge_threshold, cfg.merge_inflation))
    prune = jax.jit(lambda g: gm_ops.prune(g, cfg.prune_threshold))
    resample = jax.jit(lambda s, gmf, lw, un, nf: filt._resample_phase(
        s, gmf, lw, un, nf, z, z_mask, jnp.sum(z_mask)))
    full_update = jax.jit(lambda s: filt.update(s, z, z_mask))

    def one_pass(timer, s):
        s = timer.time("predict", predict, s)
        timer.time("mapUpdate_kf", kf, s)  # sub-phase of mapUpdate
        gmf, lw, unused, nfov, cz = timer.time("mapUpdate", map_update, s)
        lw = timer.time("particleWeighting", weighting, s, gmf, lw, cz)
        gmf = timer.time("mapMerge", merge, gmf)
        gmf = timer.time("mapPrune", prune, gmf)
        s = timer.time("particleResample", resample, s, gmf, lw, unused, nfov)
        return s

    s = one_pass(PhaseTimer(), state)           # compile warm-up
    jax.block_until_ready(full_update(s))
    timer = PhaseTimer()
    timer.time("fullStep", full_update, predict(state))  # fused-step anchor
    s = state
    for _ in range(reps):
        s = one_pass(timer, s)
    return timer
