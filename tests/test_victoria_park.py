"""Victoria Park model + app wiring tests (CPU, tiny shapes).

Covers the VictoriaPark measurement model (measure/inverse round-trip,
scan-dependent Pd, clutter), and the FastSLAM/RB-PHD Victoria Park app
builders parsing reference-format XML configs — the repository's
cfg/*VictoriaPark.xml (fastslam_VictoriaPark.cpp:85-184,
rbphdslam_VictoriaPark.cpp:85-184) — and running on a seeded synthetic
event stream written in the dataset's file formats.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from rfs_slam_tpu.models.victoria_park import VictoriaPark, fov_area_clutter

from rfs_slam_tpu.io.xmlconfig import CFG_DIR as REF_CFG


def make_model():
    return VictoriaPark(
        R=jnp.diag(jnp.asarray([0.025, 2.5e-5, 2e-3])),
        slb=jnp.asarray(1e-5),
        pd_table=jnp.asarray([0.0, 0.2, 0.4, 0.6, 0.8, 0.9]),
        r_max=70.0, r_min=1.0, b_max=3.09, b_min=-3.09,
        clutter_value=fov_area_clutter(3.0, 1.0, 70.0, -3.09, 3.09),
    )


def test_measure_inverse_roundtrip():
    m = make_model()
    pose = jnp.asarray([1.0, 2.0, 0.3])
    lm = jnp.asarray([6.0, 8.0, 0.5])
    pred = m.measure(pose, lm)
    mean, cov = m.inverse(pose, pred.z)
    np.testing.assert_allclose(np.asarray(mean), np.asarray(lm), atol=1e-5)
    # S is symmetric PSD
    S = np.asarray(pred.S)
    np.testing.assert_allclose(S, S.T, atol=1e-7)
    assert np.all(np.linalg.eigvalsh(S) > 0)
    # diameter variance grows with range^2 * slb
    lm_far = jnp.asarray([40.0, 40.0, 0.5])
    S_far = np.asarray(m.measure(pose, lm_far).S)
    assert S_far[2, 2] > S[2, 2]


def test_pd_geometry():
    m = make_model()
    pose = jnp.zeros(3)
    # lidar frame is pose rotated -pi/2: a tree at -y is at bearing ~0
    near = jnp.asarray([0.0, -5.0, 1.0])
    far = jnp.asarray([0.0, -200.0, 1.0])
    pd_near, _ = m.pd(pose, near)
    pd_far, _ = m.pd(pose, far)
    assert float(pd_near) > 0.0
    assert float(pd_far) == 0.0  # beyond range limit
    # a bigger tree at the same spot subtends more beams -> pd >= smaller
    small = jnp.asarray([0.0, -5.0, 0.05])
    pd_small, _ = m.pd(pose, small)
    assert float(pd_near) >= float(pd_small)


def test_with_scan_blocks_detection():
    m = make_model()
    pose = jnp.zeros(3)
    # lidar bearing 90 deg (vehicle +x): beam window lies inside the real
    # 361-beam half of the 720-bin circle (no wrap into zero padding)
    tree = jnp.asarray([10.0, 0.0, 1.0])
    pd_open, _ = m.pd(pose, tree)
    # a wall at 2 m in front of everything blocks the tree at 10 m
    m_wall = m.with_scan(jnp.full((361,), 2.0))
    pd_blocked, _ = m_wall.pd(pose, tree)
    assert float(pd_blocked) < float(pd_open)
    assert m_wall.has_scan
    assert float(m_wall.clutter_value) > 0


def test_fastslam_vp_build_and_step():
    from rfs_slam_tpu.apps.fastslam_victoriapark import build
    from rfs_slam_tpu.io.xmlconfig import XmlConfig

    cfg = XmlConfig(os.path.join(REF_CFG, "fastslam_VictoriaPark.xml"))
    filt, input_cov, ack = build(cfg, z_capacity=8, map_capacity=32,
                                 n_particles=4)
    assert filt.cfg.max_hypotheses == 1
    state = filt.init_state(jax.random.PRNGKey(0), jnp.zeros(3), d=3)
    state = filt.predict(state, jnp.asarray([3.0, 0.1]), 0.025,
                         use_model_noise=False, use_input_noise=True,
                         input_cov=input_cov)
    z = jnp.zeros((8, 3)).at[0].set(jnp.asarray([10.0, 1.5, 0.6]))
    z_mask = jnp.zeros((8,), bool).at[0].set(True)
    state = filt.update(state, z, z_mask)
    assert np.isfinite(np.asarray(state.particles.log_w)).all()
    assert np.isfinite(np.asarray(state.particles.pose)).all()


def test_mhfastslam_vp_build():
    from rfs_slam_tpu.apps.fastslam_victoriapark import build
    from rfs_slam_tpu.io.xmlconfig import XmlConfig

    cfg = XmlConfig(os.path.join(REF_CFG, "mhfastslam_VictoriaPark.xml"))
    filt, _, _ = build(cfg, z_capacity=8, map_capacity=32, n_particles=4)
    assert filt.cfg.max_hypotheses > 1


def test_rbphd_vp_build():
    from rfs_slam_tpu.apps.rbphdslam_victoriapark import build
    from rfs_slam_tpu.io.xmlconfig import XmlConfig

    cfg = XmlConfig(os.path.join(REF_CFG, "rbphdslam_VictoriaPark.xml"))
    filt, input_cov, ack = build(cfg, z_capacity=8, map_capacity=32,
                                 n_particles=4)
    assert filt.cfg.n_particles == 4


def _write_vp_dataset(d, extra_frames=0, seed=0):
    """Victoria Park event stream in the reference file formats
    (rbphdslam_VictoriaPark.cpp:199-324): a hand-built two-frame prefix,
    then ``extra_frames`` seeded synthetic frames — each two Input messages
    (slow forward drive, small steering), one GPS fix and one Lidar scan
    with 3-8 tree detections (range, bearing, diameter) inside the sensor's
    range and bearing limits."""
    sm = ["1.0 2 1",    # Input  idx 1
          "1.5 1 1",    # GPS (ignored by the filter loop)
          "2.0 2 2",    # Input  idx 2
          "2.5 3 1",    # Lidar  idx 1 -> frame 0
          "3.0 2 3",    # Input  idx 3
          "3.5 3 2"]    # Lidar  idx 2 -> frame 1
    inputs = ["1.0 0.0 0.1", "2.0 2.0 0.2", "3.0 3.0 0.3"]
    meas = ["2.5 10.0 1.0 0.5", "2.5 11.0 1.1 0.6", "3.5 12.0 1.2 0.7"]
    gps = ["1.0 0.0 0.0"]
    rng = np.random.default_rng(seed)
    t = 3.5
    for f in range(extra_frames):
        for _ in range(2):
            t += 0.1
            inputs.append(f"{t:.3f} {rng.uniform(1.5, 2.5):.4f} "
                          f"{rng.uniform(-0.05, 0.05):.4f}")
            sm.append(f"{t:.3f} 2 {len(inputs)}")
        gps.append(f"{t:.3f} {0.2 * f:.3f} 0.0")
        sm.append(f"{t:.3f} 1 {len(gps)}")
        t += 0.05
        sm.append(f"{t:.3f} 3 {f + 3}")
        for _ in range(rng.integers(3, 9)):
            meas.append(f"{t:.3f} {rng.uniform(6.0, 40.0):.3f} "
                        f"{rng.uniform(0.3, 2.8):.4f} "
                        f"{rng.uniform(0.2, 1.0):.3f}")
    for name, rows in (("Sensors_manager.txt", sm), ("inputs.dat", inputs),
                       ("measurements.dat", meas), ("gps.dat", gps)):
        (d / name).write_text("\n".join(rows) + "\n")


def test_frame_bucketing_hand_computed(tmp_path):
    """io/victoria_park.load vs the reference event loop hand-traced
    (rbphdslam_VictoriaPark.cpp:471-628): Input messages record a predict
    sub-step with the PREVIOUS held input and the PRE-update stationary flag;
    Lidar messages close a frame; GPS messages are skipped; steering is
    scaled by ur_scale at input-swap time."""
    from rfs_slam_tpu.io import victoria_park as vp_io

    _write_vp_dataset(tmp_path)
    fr = vp_io.load(str(tmp_path), scale_ur=2.0, z_capacity=4)

    np.testing.assert_allclose(fr.t, [2.5, 3.5])
    assert fr.pred_dt.shape == (2, 3)  # frame 0 has 3 sub-steps -> K=3

    # frame 0: Input@1.0 (dt=1.0, u=(0,0), stationary), Input@2.0 (dt=1.0,
    # u=(0, 0.1*2), still stationary: v was 0), Lidar@2.5 (dt=0.5,
    # u=(2.0, 0.2*2), no longer stationary)
    np.testing.assert_allclose(fr.pred_dt[0], [1.0, 1.0, 0.5])
    np.testing.assert_allclose(
        fr.pred_u[0], [[0.0, 0.0], [0.0, 0.2], [2.0, 0.4]])
    np.testing.assert_array_equal(fr.pred_noise[0], [False, False, True])
    np.testing.assert_array_equal(fr.pred_valid[0], [True, True, True])

    # frame 1: Input@3.0 (dt=0.5, u=(2.0, 0.4)), Lidar@3.5 (dt=0.5,
    # u=(3.0, 0.6)); third slot is dt=0 padding
    np.testing.assert_allclose(fr.pred_dt[1], [0.5, 0.5, 0.0])
    np.testing.assert_allclose(
        fr.pred_u[1][:2], [[2.0, 0.4], [3.0, 0.6]])
    np.testing.assert_array_equal(fr.pred_noise[1], [True, True, False])
    np.testing.assert_array_equal(fr.pred_valid[1], [True, True, False])

    # measurements bucketed by exact scan time
    np.testing.assert_array_equal(fr.z_mask[0], [True, True, False, False])
    np.testing.assert_allclose(fr.z[0, 0], [10.0, 1.0, 0.5])
    np.testing.assert_allclose(fr.z[0, 1], [11.0, 1.1, 0.6])
    np.testing.assert_array_equal(fr.z_mask[1], [True, False, False, False])
    np.testing.assert_allclose(fr.z[1, 0], [12.0, 1.2, 0.7])

    assert fr.scans is None  # no LASER.txt in this dataset copy


def test_frame_bucketing_message_truncation(tmp_path):
    """nMsgToProcess semantics: only the first N sensor-manager rows are
    consumed (rbphdslam_VictoriaPark.cpp:467-470)."""
    from rfs_slam_tpu.io import victoria_park as vp_io

    _write_vp_dataset(tmp_path)
    fr = vp_io.load(str(tmp_path), n_messages=4, z_capacity=4)
    np.testing.assert_allclose(fr.t, [2.5])
    assert fr.z_mask[0].sum() == 2


def test_checkpoint_resume_bit_identical(tmp_path):
    """Interrupting a chunked VP run and resuming must reproduce the
    uninterrupted run's final state and outputs exactly (the RNG key lives in
    the filter state, so chunk boundaries don't change the math)."""
    import dataclasses

    from rfs_slam_tpu.apps import rbphdslam_victoriapark as app
    from rfs_slam_tpu.io import victoria_park as vp_io
    from rfs_slam_tpu.io.xmlconfig import XmlConfig

    cfg = XmlConfig(os.path.join(REF_CFG, "rbphdslam_VictoriaPark.xml"))
    filt, input_cov, ack = app.build(cfg, z_capacity=24, map_capacity=32,
                                     n_particles=4)
    _write_vp_dataset(tmp_path, extra_frames=12)
    frames = vp_io.load(str(tmp_path),
                        scale_ur=cfg.get("process.ur_scale", 1.0),
                        z_capacity=24, n_messages=400, ackerman=ack)
    F = len(frames.t)
    assert F >= 8

    # A: monolithic reference run
    _, outs_a, _ = app.run(filt, input_cov, frames, seed=3)

    # B: chunked run killed after the first chunk
    half = F // 2
    cut = dataclasses.replace(
        frames,
        t=frames.t[:half], pred_dt=frames.pred_dt[:half],
        pred_u=frames.pred_u[:half], pred_noise=frames.pred_noise[:half],
        pred_valid=frames.pred_valid[:half], z=frames.z[:half],
        z_mask=frames.z_mask[:half], dr_pose=frames.dr_pose[:half],
    )
    d = str(tmp_path / "ckpt")
    os.makedirs(d)
    app.run(filt, input_cov, cut, seed=3, ckpt_dir=d, ckpt_every=half)

    # C: resume to completion
    state_c, outs_c, _ = app.run(filt, input_cov, frames, seed=3,
                                 ckpt_dir=d, ckpt_every=half, resume=True)

    for a, c in zip(outs_a, outs_c):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(c))


def test_update_at_origin_keeps_planes_finite():
    """Regression: round-2 root cause of the dead VP filter.

    A particle exactly at the origin (VP's initial stationary pose) makes the
    range-bearing Jacobian divide by r = 0 against the dead map slots parked
    at the origin, so the EKF's per-slot updates are NaN while the VP model's
    valid flag stays True.  Without the correct_all NaN scrub those NaNs land
    in dead slots of the map planes, and the next one-hot gather
    (planar.take_lane: NaN * 0 = NaN) poisons EVERY landmark — births went
    NaN, Pd went 0, particle weights stayed uniform, and the filter never
    localized (reference NaN guard: KalmanFilter.hpp:253-254).
    """
    from rfs_slam_tpu.apps.rbphdslam_victoriapark import build
    from rfs_slam_tpu.io.xmlconfig import XmlConfig

    cfg = XmlConfig(os.path.join(REF_CFG, "rbphdslam_VictoriaPark.xml"))
    filt, input_cov, ack = build(cfg, z_capacity=8, map_capacity=32,
                                 n_particles=2)
    state = filt.init_state(jax.random.PRNGKey(0), jnp.zeros(3), dz=3, d=3)
    z = jnp.asarray(
        [[20.46, 0.886, 0.354], [29.60, 1.021, 0.257], [12.74, 1.353, 0.111]]
        + [[0.0, 0.0, 0.0]] * 5, jnp.float32)
    z_mask = jnp.asarray([True] * 3 + [False] * 5)

    # update with the map empty and the pose at the exact origin
    state = filt.update(state, z, z_mask)
    assert np.isfinite(np.asarray(state.gm.mean)).all()
    assert np.isfinite(np.asarray(state.gm.cov)).all()
    assert np.asarray(state.last_unused)[0].sum() == 3

    # births from the unused measurements must be finite with Pd > 0
    gm, birth = filt._add_birth_gaussians(state, state.particles.key)
    alive = np.asarray(gm.alive[0])
    assert alive.sum() == 3
    assert np.isfinite(np.asarray(gm.mean)[:, 0, alive]).all()
    pd, _ = filt.meas.pd_p(state.particles.pose[:, None, :], gm.mean, gm.cov)
    assert np.asarray(pd)[0][alive].max() > 0.0

    # a second update must now produce a non-trivial weight table: the born
    # landmarks are re-detected, so at least one updated Gaussian gains
    # weight above the 0.01 birth weight
    state = state.replace(gm=gm, birth=birth)
    state = filt.update(state, z, z_mask)
    w = np.asarray(state.gm.w[0])[np.asarray(state.gm.alive[0])]
    assert np.isfinite(np.asarray(state.gm.mean)).all()
    assert w.max() > 0.5


def test_with_scan_end_to_end(tmp_path):
    """Drive the full scan-dependent Pd path (MeasurementModel_VictoriaPark
    .cpp:202-265) end-to-end: synthesize a LASER.txt consistent with
    measurements.dat, load it through the frame builder, and run the VP app
    loop over a short stream."""
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "scripts"))
    import synth_laser

    from rfs_slam_tpu.apps import rbphdslam_victoriapark as app
    from rfs_slam_tpu.io import victoria_park as vp_io
    from rfs_slam_tpu.io.xmlconfig import XmlConfig

    src = tmp_path / "stream"
    src.mkdir()
    _write_vp_dataset(src, extra_frames=12)
    out = str(tmp_path / "scan_data")
    synth_laser.synthesize(str(src), out, messages=600)
    cfg = XmlConfig(os.path.join(REF_CFG, "rbphdslam_VictoriaPark.xml"))
    filt, input_cov, ack = app.build(cfg, z_capacity=24, map_capacity=32,
                                     n_particles=4)
    frames = vp_io.load(out, scale_ur=cfg.get("process.ur_scale", 1.0),
                        z_capacity=24, n_messages=600, ackerman=ack)
    assert frames.scans is not None and frames.scans.shape[1] == 361
    assert (frames.scans > 0).any()
    state, outs, _ = app.run(filt, input_cov, frames, seed=1)
    poses = outs[0]
    assert np.isfinite(poses).all()
    # scan-based Pd actually engaged: scans carry real returns under r_max
    assert (frames.scans < 74.0).any()
