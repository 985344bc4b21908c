"""Aux subsystems: checkpoint/resume, Frame2d, spatial index, memprofile,
timing."""

import numpy as np
import jax
import jax.numpy as jnp

from rfs_slam_tpu.core import frame2d
from rfs_slam_tpu.ops import spatial
from rfs_slam_tpu.utils import checkpoint, memprofile
from rfs_slam_tpu.utils.timing import PhaseTimer


# ------------------------------------------------------------- checkpoint
def test_checkpoint_roundtrip(tmp_path):
    from rfs_slam_tpu.filters.rbphd import RBPHDConfig, RBPHDFilter
    from rfs_slam_tpu.models.motion import Odometry2D, StaticLandmark
    from rfs_slam_tpu.models.measurement import RangeBearing
    from rfs_slam_tpu.ops.ekf import InnovationGates

    filt = RBPHDFilter(
        Odometry2D(Q=jnp.eye(3) * 1e-4), StaticLandmark(Q=jnp.eye(2) * 1e-5),
        RangeBearing(R=jnp.eye(2) * 1e-3, pd_const=0.95, clutter=1e-4,
                     r_max=5.0, r_min=0.5, r_buf=0.1),
        InnovationGates.range_bearing(1.0, 0.2),
        RBPHDConfig(n_particles=8, map_capacity=16, z_capacity=4,
                    new_capacity=8, birth_capacity=4, eval_capacity=4,
                    z_dp_max=4))
    state = filt.init_state(jax.random.PRNGKey(7), jnp.zeros(3))
    state = filt.predict(state, jnp.asarray([0.1, 0.0, 0.02]), 0.1)

    d = str(tmp_path / "ckpts")
    checkpoint.save(d, 3, state)
    checkpoint.save(d, 7, state)
    assert checkpoint.latest_step(d) == 7

    template = filt.init_state(jax.random.PRNGKey(0), jnp.zeros(3))
    step, restored = checkpoint.restore(d, template)
    assert step == 7
    for a, b in zip(jax.tree_util.tree_leaves(state),
                    jax.tree_util.tree_leaves(restored)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_checkpoint_rotation(tmp_path):
    d = str(tmp_path / "r")
    state = {"a": jnp.arange(4.0)}
    for k in range(6):
        checkpoint.save(d, k, state, keep=2)
    assert checkpoint.latest_step(d) == 5
    step, _ = checkpoint.restore(d, state, step=4)
    assert step == 4
    try:
        checkpoint.restore(d, state, step=0)
        assert False, "rotated checkpoint should be gone"
    except FileNotFoundError:
        pass


# ---------------------------------------------------------------- frame2d
def test_frame_compose_inverse_identity():
    pose = jnp.asarray([1.0, 2.0, 0.7])
    cov = jnp.diag(jnp.asarray([0.01, 0.02, 0.005]))
    inv_p, inv_c = frame2d.inverse(pose, cov)
    ident, _ = frame2d.compose(pose, cov, inv_p, jnp.zeros((3, 3)))
    np.testing.assert_allclose(np.asarray(ident), 0.0, atol=1e-6)


def test_frame_compose_matches_monte_carlo(rng):
    pose_a = jnp.asarray([0.5, -0.2, 0.4])
    pose_b = jnp.asarray([1.0, 0.3, -0.2])
    cov_a = jnp.diag(jnp.asarray([0.02, 0.03, 0.004]))
    cov_b = jnp.diag(jnp.asarray([0.01, 0.01, 0.002]))
    pose_c, cov_c = frame2d.compose(pose_a, cov_a, pose_b, cov_b)

    # Monte-Carlo covariance of the composition
    n = 20000
    sa = rng.multivariate_normal(np.asarray(pose_a), np.asarray(cov_a), n)
    sb = rng.multivariate_normal(np.asarray(pose_b), np.asarray(cov_b), n)
    c, s = np.cos(sa[:, 2]), np.sin(sa[:, 2])
    xs = sa[:, 0] + c * sb[:, 0] - s * sb[:, 1]
    ys = sa[:, 1] + s * sb[:, 0] + c * sb[:, 1]
    ts = sa[:, 2] + sb[:, 2]
    samples = np.stack([xs, ys, ts], axis=1)
    np.testing.assert_allclose(samples.mean(0), np.asarray(pose_c), atol=0.01)
    np.testing.assert_allclose(np.cov(samples.T), np.asarray(cov_c),
                               atol=0.004)


def test_chain_to_base():
    # three unit steps forward with 90-degree turns traces a square
    rel = jnp.asarray([[1.0, 0.0, np.pi / 2]] * 4)
    covs = jnp.zeros((4, 3, 3))
    abs_p, _ = frame2d.chain_to_base(rel, covs)
    np.testing.assert_allclose(np.asarray(abs_p[-1][:2]), [0.0, 0.0],
                               atol=1e-5)


# ----------------------------------------------------------------- spatial
def test_spatial_box_query_matches_bruteforce(rng):
    pts = rng.uniform(0, 10, size=(200, 2)).astype(np.float32)
    mask = rng.random(200) < 0.9
    idx = spatial.build(jnp.asarray(pts), jnp.asarray(mask),
                        origin=(0.0, 0.0), cell=1.0, res=(10, 10))
    lo, hi = (2.0, 3.0), (6.5, 8.0)
    got, valid = spatial.query_box(idx, lo, hi, max_results=128)
    got = set(np.asarray(got)[np.asarray(valid)].tolist())
    want = set(np.nonzero(
        (pts[:, 0] >= lo[0]) & (pts[:, 1] >= lo[1])
        & (pts[:, 0] <= hi[0]) & (pts[:, 1] <= hi[1]) & mask)[0].tolist())
    assert got == want


def test_spatial_nearest_matches_bruteforce(rng):
    pts = rng.uniform(0, 10, size=(300, 2)).astype(np.float32)
    mask = np.ones(300, bool)
    idx = spatial.build(jnp.asarray(pts), jnp.asarray(mask),
                        origin=(0.0, 0.0), cell=1.0, res=(10, 10))
    qs = rng.uniform(1, 9, size=(20, 2)).astype(np.float32)
    near = jax.vmap(lambda q: spatial.nearest(idx, q, n_rings=2))(
        jnp.asarray(qs))
    got_idx, got_d, found = (np.asarray(a) for a in near)
    for i, q in enumerate(qs):
        d = np.linalg.norm(pts - q, axis=1)
        assert found[i]
        assert got_idx[i] == np.argmin(d)
        np.testing.assert_allclose(got_d[i], d.min(), rtol=1e-5)


# ------------------------------------------------------------- memprofile
def test_memprofile_probes():
    assert memprofile.current_rss() > 0
    assert memprofile.peak_rss() >= memprofile.current_rss() // 2
    assert "host RSS" in memprofile.report()


# ----------------------------------------------------------------- timing
def test_phase_timer():
    t = PhaseTimer()
    out = t.time("phase_a", lambda: jnp.sum(jnp.arange(100.0)))
    assert float(out) == 4950.0
    rep = t.report()
    wall, cpu = rep["phase_a"]
    assert wall > 0 and cpu >= 0
    assert "phase_a" in t.table()


# ------------------------------------------------------------ convertlogs
def test_convert_log_files(tmp_path):
    from rfs_slam_tpu.apps import convertlogfiles

    d = str(tmp_path)
    with open(f"{d}/particlePose.dat", "w") as f:
        f.write("Timesteps: 2\n")
        for k, t in enumerate([0.1, 0.2]):
            f.write(f"k = {t}\nnParticles = 2\n")
            f.write("1.0 2.0 0.5 0.9\n3.0 4.0 0.6 0.1\n")
    with open(f"{d}/landmarkEst.dat", "w") as f:
        f.write("Timesteps: 2\nnParticles: 2\n")
        f.write("Timestep: 0.1   Particle: 0   Map Size: 1\n")
        f.write("5.0 6.0 0.01 0.001 0.001 0.02 0.8\n")
    assert convertlogfiles.main([d]) == 0
    rows = open(f"{d}/particlePose.dat").read().splitlines()
    assert rows[0].split()[:2] == ["0.100000", "0"]
    assert len(rows) == 4
    lm = open(f"{d}/landmarkEst.dat").read().split()
    # Syx column dropped: t i x y Sxx Sxy Syy w
    assert len(lm) == 8 and lm[6] == "0.020000"
    import os
    assert os.path.exists(f"{d}/particlePose.bak")


# ---------------------------------------------------------------- native IO
def test_native_io_matches_python(tmp_path):
    import pytest
    from rfs_slam_tpu.io import logs, native

    if native.lib() is None:
        pytest.skip("librfsio.so not built")

    T, P, M = 3, 4, 5
    rng = np.random.default_rng(0)
    times = np.arange(1, T + 1) * 0.1
    poses = rng.normal(size=(T, P, 3))
    weights = rng.random((T, P))
    best = rng.integers(0, P, T)
    means = rng.normal(size=(T, M, 2))
    covs = rng.random((T, M, 3))
    alive = rng.random((T, M)) < 0.7

    d_nat, d_py = str(tmp_path / "nat"), str(tmp_path / "py")
    logs.write_particle_poses(d_nat, times, poses, weights)
    logs.write_landmark_estimates(d_nat, times, best, means, covs,
                                  rng.random((T, M)), alive)
    # force the python path
    real_lib = native._LIB
    native._LIB = None
    try:
        logs.write_particle_poses(d_py, times, poses, weights)
    finally:
        native._LIB = real_lib
    a = open(f"{d_nat}/particlePose.dat").read()
    b = open(f"{d_py}/particlePose.dat").read()
    assert a == b
    # alive-filtered landmark rows present
    n_rows = len(open(f"{d_nat}/landmarkEst.dat").read().splitlines())
    assert n_rows == int(alive.sum())


def test_native_loadtxt_matches_numpy(tmp_path):
    import pytest
    from rfs_slam_tpu.io import native

    if native.lib() is None:
        pytest.skip("librfsio.so not built")
    p = str(tmp_path / "vals.dat")
    rng = np.random.default_rng(1)
    arr = rng.normal(size=(50, 4))
    np.savetxt(p, arr)
    got = native.loadtxt(p)
    np.testing.assert_allclose(got, arr, rtol=1e-12)


# ---------------------------------------------------------- map integrity
def test_check_map_integrity():
    """RBPHDFilter::checkMapIntegrity analog (RBPHDFilter.hpp:1087-1150)."""
    from rfs_slam_tpu.core.state import GMState
    from rfs_slam_tpu.utils.integrity import check_map_integrity

    gm = GMState.empty(2, 4, 2)
    gm = gm.replace(
        mean=gm.mean.at[:, 0, 0].set(1.0),
        cov=gm.cov.at[:, 0, 0].set(jnp.asarray([0.1, 0.0, 0.1])),
        w=gm.w.at[0, 0].set(0.5),
        alive=gm.alive.at[0, 0].set(True),
    )
    ok, rep = check_map_integrity(gm)
    assert ok, rep

    bad = gm.replace(mean=gm.mean.at[0, 0, 0].set(jnp.nan))
    ok, rep = check_map_integrity(bad)
    assert not ok and rep["mean_nonfinite"] == 1

    # dead slots are ignored even when garbage
    bad2 = gm.replace(mean=gm.mean.at[0, 0, 3].set(jnp.nan))
    ok, _ = check_map_integrity(bad2)
    assert ok

    # non-positive covariance quadratic form
    bad3 = gm.replace(cov=gm.cov.at[:, 0, 0].set(jnp.asarray([0.1, -0.2, 0.1])))
    ok, rep = check_map_integrity(bad3)
    assert not ok and rep["cov_nonpositive"] == 1


# ---------------------------------------------------------------- struct
def _point_cls():
    from rfs_slam_tpu.core import struct

    class Point(struct.PyTreeNode):
        x: jax.Array
        y: jax.Array = struct.field(default=0.0)
        tag: str = struct.field(pytree_node=False, default="p")

    return Point


def test_struct_replace_and_defaults():
    Point = _point_cls()
    p = Point(x=jnp.ones(2))
    q = p.replace(y=jnp.full(2, 3.0))
    assert float(p.y) == 0.0 and p.tag == "p"
    np.testing.assert_array_equal(np.asarray(q.y), [3.0, 3.0])
    assert q.x is p.x
    try:
        p.x = jnp.zeros(2)
        assert False, "PyTreeNode fields must be frozen"
    except AttributeError:
        pass


def test_struct_meta_fields_are_static():
    Point = _point_cls()
    p = Point(x=jnp.ones(2), tag="a")
    leaves, treedef = jax.tree_util.tree_flatten(p)
    assert len(leaves) == 2                   # x, y — tag is metadata
    assert jax.tree_util.tree_flatten(p.replace(tag="b"))[1] != treedef
    assert jax.tree_util.tree_unflatten(treedef, leaves).tag == "a"


def test_struct_jit_round_trip():
    Point = _point_cls()

    @jax.jit
    def f(p):
        return p.replace(x=p.x * 2.0, y=p.y + 1.0)

    out = f(Point(x=jnp.arange(3.0), y=jnp.asarray(1.0), tag="t"))
    assert isinstance(out, Point) and out.tag == "t"
    np.testing.assert_array_equal(np.asarray(out.x), [0.0, 2.0, 4.0])
    assert float(out.y) == 2.0


# ----------------------------------------------------------------- cache
def test_cache_honours_env_var(tmp_path, monkeypatch):
    from rfs_slam_tpu.utils import cache

    old = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    try:
        assert cache.enable() == str(tmp_path / "c")
        assert jax.config.jax_compilation_cache_dir == str(tmp_path / "c")
        assert (tmp_path / "c").is_dir()
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_cache_default_is_checkout_dir(monkeypatch):
    import os

    from rfs_slam_tpu.utils import cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert cache.cache_dir() == os.path.join(root, ".jax_cache")
