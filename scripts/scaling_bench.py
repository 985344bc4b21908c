"""Scaling-efficiency harness: per-device throughput vs particle-shard count.

Weak-scaling methodology for the BASELINE.md north star (>= 80% efficiency at
2+ hosts): hold the per-device particle count fixed, grow the device count,
and measure steps/s of the fully sharded RB-PHD step (predict + update with
global weight normalization/ESS + cross-shard resampling gather — the only
collectives of the filter, SURVEY.md section 2.8).  Efficiency(n) =
time(1 device) / time(n devices); a perfectly scaling weak workload stays at
1.0.

Without GPUs the harness runs on the virtual CPU mesh
(``--xla_force_host_platform_device_count``).  CAVEAT: virtual devices share
the host's cores, so absolute steps/s SHRINKS with n by construction — the
meaningful output there is the COLLECTIVE SHARE column (how much of the step
the mesh spends in cross-shard work); the same script on four GPUs reports
true efficiency.

Run: JAX_PLATFORMS=cpu python scripts/scaling_bench.py [--devices 1 2 4 8]
Writes scaling_results.dat in timing.dat-like columns.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
        + " --xla_backend_optimization_level=0"
        + " --xla_llvm_disable_expensive_passes=true"
    ).strip()

from rfs_slam_tpu.utils import cache  # noqa: E402

cache.enable()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import __graft_entry__ as ge  # noqa: E402
from rfs_slam_tpu.parallel import mesh as mesh_lib  # noqa: E402


def bench_n(n_devices: int, per_device: int, steps: int, devices):
    filt = ge._build(n_particles=per_device * n_devices, map_capacity=64,
                     z_capacity=8, new_capacity=32, eval_capacity=8,
                     z_dp_max=6)
    mesh = mesh_lib.make_mesh(n_devices, devices=devices[:n_devices])
    with jax.default_device(devices[0]):
        state, odo, z, z_mask = ge._example_inputs(filt, jax.random.PRNGKey(0))
        shardings = mesh_lib.state_shardings(state, mesh,
                                             per_device * n_devices)
        state = jax.tree_util.tree_map(jax.device_put, state, shardings)
        repl = mesh_lib.replicated(mesh)
        odo, z, z_mask = jax.device_put((odo, z, z_mask), repl)

        def step(s, _):
            s = filt.predict(s, odo, 0.1)
            return filt.update(s, z, z_mask), None

        @jax.jit
        def run(s):
            return jax.lax.scan(step, s, None, length=steps)[0]

        out = run(state)
        jax.block_until_ready(out)            # compile
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            out = run(state)
            jax.block_until_ready(out)
            best = min(best, time.perf_counter() - t0)
    return best / steps


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--per-device", type=int, default=32)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--out", default="scaling_results.dat")
    args = ap.parse_args()

    devices = jax.devices()
    if len(devices) < max(args.devices):
        devices = jax.devices("cpu")
    print(f"devices: {len(devices)} x {devices[0].platform}")

    rows = []
    t1 = None
    for n in args.devices:
        if n > len(devices):
            print(f"skip n={n}: only {len(devices)} devices")
            continue
        dt = bench_n(n, args.per_device, args.steps, devices)
        # same TOTAL particles on a single device: on shared-core virtual
        # meshes both variants get the same physical compute budget, so this
        # ratio isolates the sharding/collective overhead — the quantity the
        # >= 80% multi-host target turns on (on real hardware it also equals
        # strong-scaling efficiency x n).
        dt_1 = bench_n(1, args.per_device * n, args.steps, devices)
        if t1 is None:
            t1 = dt
        eff_weak = t1 / dt
        overhead = dt / dt_1 - 1.0
        rows.append((n, args.per_device * n, dt, dt_1, eff_weak, overhead))
        print(f"n={n}: {args.per_device * n} particles, {dt * 1e3:8.2f} ms/step "
              f"sharded vs {dt_1 * 1e3:8.2f} unsharded -> sharding overhead "
              f"{overhead:+6.1%} (raw weak eff {eff_weak:6.1%})")

    with open(args.out, "w") as f:
        f.write(f"# platform={devices[0].platform} per_device_particles="
                f"{args.per_device} steps={args.steps}\n")
        f.write("# n_devices  total_particles  ms_per_step_sharded  "
                "ms_per_step_1dev_same_total  weak_eff  sharding_overhead\n")
        for n, p, dt, dt_1, eff, ov in rows:
            f.write(f"{n}  {p}  {dt * 1e3:.3f}  {dt_1 * 1e3:.3f}  "
                    f"{eff:.4f}  {ov:.4f}\n")
    print(f"results -> {args.out}")


if __name__ == "__main__":
    main()
