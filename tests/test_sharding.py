"""Multi-device sharding tests on the virtual 8-device CPU mesh."""

import numpy as np
import jax
import jax.numpy as jnp

from rfs_slam_tpu.parallel import mesh as mesh_lib


def cpu_devices(n):
    d = jax.devices("cpu")
    assert len(d) >= n
    return d[:n]


def test_mesh_and_shardings():
    import __graft_entry__ as g

    devs = cpu_devices(4)
    mesh = mesh_lib.make_mesh(4, devices=devs)
    filt = g._build(n_particles=8, map_capacity=16, z_capacity=4,
                    new_capacity=8, eval_capacity=4, z_dp_max=4)
    with jax.default_device(devs[0]):
        state, _, _, _ = g._example_inputs(filt, jax.random.PRNGKey(0))
    shardings = mesh_lib.state_shardings(state, mesh, 8)
    # particle-axis arrays shard, scalars/z replicate
    assert shardings.gm.mean.spec == jax.sharding.PartitionSpec(None, "particles")
    assert shardings.last_z.spec == jax.sharding.PartitionSpec()
    assert shardings.n_updates.spec == jax.sharding.PartitionSpec()


def test_sharded_step_matches_single_device():
    """The full filter step must be invariant to particle-axis sharding.

    This is the determinism test replacing the reference's (absent) race
    detection: same seed => identical outputs across shardings
    (SURVEY.md section 5).
    """
    import __graft_entry__ as g

    filt = g._build(n_particles=8, map_capacity=16, z_capacity=4,
                    new_capacity=8, eval_capacity=4, z_dp_max=4)
    devs = cpu_devices(4)
    with jax.default_device(devs[0]):
        state, odo, z, zm = g._example_inputs(filt, jax.random.PRNGKey(0))

        def step(s, o, zz, zzm):
            s = filt.predict(s, o, 0.1)
            return filt.update(s, zz, zzm)

        ref = jax.jit(step)(state, odo, z, zm)
        ref = jax.tree_util.tree_map(np.asarray, ref)

        mesh = mesh_lib.make_mesh(4, devices=devs)
        shardings = mesh_lib.state_shardings(state, mesh, 8)
        repl = mesh_lib.replicated(mesh)
        s_sh = jax.tree_util.tree_map(jax.device_put, state, shardings)
        sharded = jax.jit(
            step, in_shardings=(shardings, repl, repl, repl),
            out_shardings=shardings,
        )(s_sh, *jax.device_put((odo, z, zm), repl))
        sharded = jax.tree_util.tree_map(np.asarray, sharded)

    np.testing.assert_allclose(
        ref.particles.pose, sharded.particles.pose, rtol=1e-5, atol=1e-5
    )
    np.testing.assert_allclose(
        ref.particles.log_w, sharded.particles.log_w, rtol=1e-4, atol=1e-4
    )
    np.testing.assert_array_equal(ref.gm.alive, sharded.gm.alive)
    np.testing.assert_allclose(ref.gm.w, sharded.gm.w, rtol=1e-4, atol=1e-5)


def test_dryrun_multichip():
    import __graft_entry__ as g

    g.dryrun_multichip(8)


def test_sharded_multistep_run_matches_single_device():
    """A 60-step sharded sim run (with repeated resampling migrating
    particles across shards) must match the single-device run.  The one-step
    test above can't catch state corruption introduced by the resample
    gather's all-to-all; this drives it repeatedly."""
    import __graft_entry__ as g

    filt = g._build(n_particles=8, map_capacity=16, z_capacity=4,
                    new_capacity=8, eval_capacity=4, z_dp_max=4)
    devs = cpu_devices(4)
    T = 60
    with jax.default_device(devs[0]):
        state, odo, z, zm = g._example_inputs(filt, jax.random.PRNGKey(0))
        key = jax.random.PRNGKey(7)
        odos = jax.random.normal(key, (T, 3)) * 0.05 + odo[None]
        zs = jnp.tile(z[None], (T, 1, 1))
        zms = jnp.tile(zm[None], (T, 1))

        def step(s, inp):
            o, zz, zzm = inp
            s = filt.predict(s, o, 0.1)
            s = filt.update(s, zz, zzm)
            return s, s.particles.parent

        def run(s, inputs):
            return jax.lax.scan(step, s, inputs)

        ref, ref_parents = jax.jit(run)(state, (odos, zs, zms))
        ref = jax.tree_util.tree_map(np.asarray, ref)
        # the scenario must actually resample (parent != identity) repeatedly
        n_resamples = int(np.sum(
            np.any(np.asarray(ref_parents) != np.arange(8)[None], axis=1)))
        assert n_resamples >= 3, f"only {n_resamples} resampling events"

        mesh = mesh_lib.make_mesh(4, devices=devs)
        shardings = mesh_lib.state_shardings(state, mesh, 8)
        repl = mesh_lib.replicated(mesh)
        s_sh = jax.tree_util.tree_map(jax.device_put, state, shardings)
        inp_sh = jax.device_put((odos, zs, zms), repl)
        sharded, _ = jax.jit(
            run, in_shardings=(shardings, (repl, repl, repl)),
            out_shardings=(shardings, repl),
        )(s_sh, inp_sh)
        sharded = jax.tree_util.tree_map(np.asarray, sharded)

    np.testing.assert_allclose(
        ref.particles.pose, sharded.particles.pose, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        ref.particles.log_w, sharded.particles.log_w, rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(ref.particles.parent,
                                  sharded.particles.parent)
    np.testing.assert_array_equal(ref.gm.alive, sharded.gm.alive)
    np.testing.assert_allclose(ref.gm.w, sharded.gm.w, rtol=1e-3, atol=1e-4)


def test_distributed_two_process_smoke():
    """jax.distributed multi-process path: two CPU processes with gloo
    collectives run init_distributed + the resampler's global collectives
    over a 2x2-device mesh (SURVEY.md section 2.8 distributed backend row)."""
    import os
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    worker = os.path.join(os.path.dirname(__file__), "dist_smoke_worker.py")
    procs = [
        subprocess.Popen([sys.executable, worker, str(pid), str(port)],
                         env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True)
        for pid in (0, 1)
    ]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=180)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append((p.returncode, out, err))
    assert outs[0][0] == 0, outs[0][2][-2000:]
    assert outs[1][0] == 0, outs[1][2][-2000:]
    assert "DIST-OK" in outs[0][1]


def test_landmark_axis_sharding_matches_single_device():
    """Map-block parallelism (SURVEY.md section 2.8 row 4): sharding the
    landmark axis across a 2x4 particles-x-map mesh must not change the
    filter step.  The cross-M reductions (weight-table column sums,
    importance-weighting intensity sums, top-k compaction) become GSPMD
    collectives over the map axis."""
    import __graft_entry__ as g

    filt = g._build(n_particles=8, map_capacity=16, z_capacity=4,
                    new_capacity=8, eval_capacity=4, z_dp_max=4)
    devs = cpu_devices(8)
    with jax.default_device(devs[0]):
        state, odo, z, zm = g._example_inputs(filt, jax.random.PRNGKey(0))

        def step(s, o, zz, zzm):
            s = filt.predict(s, o, 0.1)
            return filt.update(s, zz, zzm)

        ref = jax.jit(step)(state, odo, z, zm)
        ref = jax.tree_util.tree_map(np.asarray, ref)

        mesh = mesh_lib.make_mesh_2d(2, 4, devices=devs)
        shardings = mesh_lib.state_shardings_2d(state, mesh, 8, 16)
        repl = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec())
        s_sh = jax.tree_util.tree_map(jax.device_put, state, shardings)
        sharded = jax.jit(
            step, in_shardings=(shardings, repl, repl, repl),
            out_shardings=shardings,
        )(s_sh, *jax.device_put((odo, z, zm), repl))
        sharded = jax.tree_util.tree_map(np.asarray, sharded)

    np.testing.assert_allclose(
        ref.particles.pose, sharded.particles.pose, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        ref.particles.log_w, sharded.particles.log_w, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(ref.gm.alive, sharded.gm.alive)
    np.testing.assert_allclose(ref.gm.w, sharded.gm.w, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ref.gm.mean, sharded.gm.mean, rtol=1e-4,
                               atol=1e-4)
