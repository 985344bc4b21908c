"""Map-overflow demonstration for landmark-axis (map-block) sharding.

SURVEY.md section 2.8 row 4's design justification is that the map axis
pays when a single particle's map outgrows one device: this script exhibits
that concretely.

Mode ``gpu`` (run on one card): AOT-compile the full RB-PHD update step at
a map capacity chosen so the [P, Z, M] update cubes + O(M^2) merge gate
approach or exceed the card's memory; print the compiler's own memory
analysis (temp bytes), then attempt one execution and report the outcome.

Mode ``mesh`` (runs anywhere; use the 8-virtual-device CPU mesh):
execute the SAME shapes sharded over a 2 x 4 particles x map mesh
(parallel/mesh.state_shardings_2d) and report per-device analytic bytes and
ms/step — the program a single chip cannot hold, running under GSPMD.

Usage::

    # on one GPU (raise --map until the single card runs out of memory)
    python scripts/map_overflow_demo.py gpu --particles 64 --map 8192

    # virtual 8-device mesh (executes)
    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python scripts/map_overflow_demo.py mesh --particles 64 --map 8192
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rfs_slam_tpu.utils import cache
cache.enable()

import jax
import jax.numpy as jnp
import numpy as np

import __graft_entry__ as ge
from rfs_slam_tpu.parallel import mesh as mesh_lib


def build(p, m, zc):
    return ge._build(n_particles=p, map_capacity=m, z_capacity=zc,
                     new_capacity=32, eval_capacity=8, z_dp_max=6)


def analytic(p, m, zc):
    cube = p * zc * m * 4
    merge_gate = p * m * m * 4
    planes = 10 * p * m * 4
    print(f"analytic per-cube [P,Zc,M] = {cube/2**30:.2f} GiB "
          f"(several live at once); merge gate [P,M,M] = "
          f"{merge_gate/2**30:.2f} GiB; planes ~{planes/2**20:.0f} MiB")


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("mode", choices=["gpu", "mesh"])
    ap.add_argument("--particles", type=int, default=64)
    ap.add_argument("--map", type=int, default=8192)
    ap.add_argument("--zc", type=int, default=16)
    ap.add_argument("--mesh-shape", type=int, nargs=2, default=[2, 4])
    args = ap.parse_args()
    p, m, zc = args.particles, args.map, args.zc
    analytic(p, m, zc)
    filt = build(p, m, zc)

    def step(state, odo, z, z_mask):
        state = filt.predict(state, odo, 0.1)
        return filt.update(state, z, z_mask)

    if args.mode == "gpu":
        state, odo, z, z_mask = ge._example_inputs(filt, jax.random.PRNGKey(0))
        t0 = time.time()
        lowered = jax.jit(step).lower(state, odo, z, z_mask)
        compiled = lowered.compile()
        print(f"compiled in {time.time()-t0:.1f}s on {jax.devices()[0]}")
        try:
            ma = compiled.memory_analysis()
            print(f"compiler memory analysis: temp "
                  f"{ma.temp_size_in_bytes/2**30:.2f} GiB, output "
                  f"{ma.output_size_in_bytes/2**30:.2f} GiB, argument "
                  f"{ma.argument_size_in_bytes/2**30:.2f} GiB")
        except Exception as e:  # noqa: BLE001
            print(f"memory_analysis unavailable: {e}")
        try:
            out = compiled(state, odo, z, z_mask)
            jax.block_until_ready(out)
            print("single-device execution SUCCEEDED at these shapes "
                  "(raise --map to exhibit the overflow)")
        except Exception as e:  # noqa: BLE001
            print(f"single-device execution FAILED as expected: "
                  f"{type(e).__name__}: {str(e)[:500]}")
        return

    a, b = args.mesh_shape
    devices = jax.devices()
    assert len(devices) >= a * b, (
        f"need {a*b} devices (run with "
        f"XLA_FLAGS=--xla_force_host_platform_device_count={a*b})")
    mesh = mesh_lib.make_mesh_2d(a, b, devices=devices)
    state, odo, z, z_mask = ge._example_inputs(filt, jax.random.PRNGKey(0))
    sh = mesh_lib.state_shardings_2d(state, mesh, p, m)
    state = jax.tree_util.tree_map(jax.device_put, state, sh)
    repl = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec())
    odo, z, z_mask = jax.device_put((odo, z, z_mask), repl)
    stepj = jax.jit(step, in_shardings=(sh, repl, repl, repl),
                    out_shardings=sh)
    t0 = time.time()
    out = jax.block_until_ready(stepj(state, odo, z, z_mask))
    print(f"sharded first step (incl compile): {time.time()-t0:.1f}s "
          f"on {a}x{b} mesh")
    t0 = time.time()
    out = jax.block_until_ready(stepj(out, odo, z, z_mask))
    print(f"sharded steady step: {(time.time()-t0)*1e3:.0f} ms")
    per_dev_cube = p * zc * m * 4 / (a * b)
    per_dev_gate = p * m * m * 4 / (a * b)
    print(f"per-device analytic: cube {per_dev_cube/2**30:.2f} GiB, "
          f"merge gate {per_dev_gate/2**30:.2f} GiB over {a*b} devices")
    w = out.particles.log_w
    assert np.isfinite(np.asarray(jax.device_get(w))).any()
    print("state finite; map-block sharding executes the overflow shapes")


if __name__ == "__main__":
    main()
