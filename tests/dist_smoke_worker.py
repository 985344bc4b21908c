"""Worker for the 2-process jax.distributed smoke test (test_sharding.py).

Run as: python tests/dist_smoke_worker.py <process_id> <port>

Exercises parallel/mesh.py's ``init_distributed`` end to end on the CPU
backend with gloo collectives: a global 2-process x 2-device mesh, a
particle-sharded global array, and the global weight-normalization /
effective-sample-size collectives the resampler relies on (SURVEY.md
section 2.8).  The worker forces the cpu platform and clears backends after
the distributed runtime is up, so the CPU client is created with the
2-process topology.
"""

import sys

import numpy as np

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_cpu_collectives_implementation", "gloo")
jax.config.update("jax_num_cpu_devices", 2)

import jax.numpy as jnp  # noqa: E402


def main(pid: int, port: str) -> None:
    from rfs_slam_tpu.parallel import mesh as mesh_lib

    mesh_lib.init_distributed(f"127.0.0.1:{port}", 2, pid)
    import jax.extend.backend as jeb

    jeb.clear_backends()  # recreate the CPU client with the global topology
    assert jax.process_count() == 2, jax.process_count()
    assert jax.device_count() == 4, jax.device_count()

    mesh = mesh_lib.make_mesh()
    sh = mesh_lib.particle_sharding(mesh)
    P = 8
    log_w = jax.make_array_from_callback(
        (P,), sh, lambda idx: np.log(np.arange(1, P + 1, dtype=np.float32))[idx])

    from rfs_slam_tpu.ops import resample

    # global ESS: for w_i proportional to i, N_eff = (sum i)^2 / sum i^2
    ess = jax.jit(resample.effective_count)(log_w)
    expect = (P * (P + 1) / 2) ** 2 / sum(i * i for i in range(1, P + 1))
    assert abs(float(ess) - expect) < 1e-3, (float(ess), expect)

    # global normalization stays sharded; total mass 1 via replicated sum
    log_wn = jax.jit(resample.normalize_log_weights, out_shardings=sh)(log_w)
    total = jax.jit(lambda a: jnp.sum(jnp.exp(a)))(log_wn)
    assert abs(float(total) - 1.0) < 1e-5, float(total)

    if pid == 0:
        print("DIST-OK", flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]), sys.argv[2])
