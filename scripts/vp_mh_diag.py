"""Score an MH VP run's divergence structure from its checkpoint outputs.

Reads the per-chunk outs saved by the checkpointed run (outs_*.npz in the
ckpt dir), reconstructs the final best particle's ancestral path, and
prints: total RMSE vs GPS, RMSE by stream quartile, per-GPS-fix error
percentiles, and the first time the error crosses 10 m (the round-4
divergence signature).  Use on the base run and on every counterfactual
resume probe.

Run: python scripts/vp_mh_diag.py <ckpt_dir> <VictoriaPark dataset dir>
     [--from-frame N]
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from rfs_slam_tpu.apps import _vp_common
from rfs_slam_tpu.apps.rbphdslam_victoriapark import gps_rmse
from rfs_slam_tpu.io import logs
from rfs_slam_tpu.io import victoria_park as vp_io
from rfs_slam_tpu.io.xmlconfig import XmlConfig, default_cfg

ckpt_dir, data_dir = sys.argv[1], sys.argv[2]
from_frame = 0
if "--from-frame" in sys.argv:
    from_frame = int(sys.argv[sys.argv.index("--from-frame") + 1])

cfg = XmlConfig(default_cfg("mhfastslam_VictoriaPark.xml"))
ack = (cfg.get("process.AckermanModel.rearWheelOffset", 0.76),
       cfg.get("process.AckermanModel.frontToRearDist", 2.83),
       cfg.get("process.AckermanModel.sensorOffset_x", 3.78),
       cfg.get("process.AckermanModel.sensorOffset_y", 0.5))
frames = vp_io.load(data_dir,
                    scale_ur=cfg.get("process.ur_scale", 1.0),
                    z_capacity=24, ackerman=ack)
F = len(frames.t)

chunks = _vp_common._load_out_chunks(ckpt_dir, F)
outs = [np.concatenate([c[i] for c in chunks], axis=0)
        for i in range(len(chunks[0]))]
poses, weights, best, gm_mean, gm_cov, gm_w, gm_alive, parents = outs
best_path = logs.ancestral_path(poses, parents, best[-1])

t = frames.t
print(f"{F} frames, stream t in [{t[0]:.0f}, {t[-1]:.0f}] s"
      + (f"; scoring from frame {from_frame}" if from_frame else ""))
sl = slice(from_frame, F)
print(f"RMSE vs GPS: {gps_rmse(t[sl], best_path[sl], frames.gps):.2f} m")

q = max((F - from_frame) // 4, 1)
for k in range(4):
    s = from_frame + k * q
    e = from_frame + (k + 1) * q if k < 3 else F
    r = gps_rmse(t[s:e], best_path[s:e], frames.gps)
    print(f"  quartile {k + 1} (frames {s}-{e}, t {t[s]:.0f}-{t[e - 1]:.0f}):"
          f" {r:.2f} m")

# per-fix error trace: nearest-frame match, report first crossing > 10 m
gt = frames.gps
gi = np.searchsorted(t, gt[:, 0])
gi = np.clip(gi, 0, F - 1)
gi0 = np.clip(gi - 1, 0, F - 1)
pick = np.abs(t[gi0] - gt[:, 0]) < np.abs(t[gi] - gt[:, 0])
gi = np.where(pick, gi0, gi)
keep = np.abs(t[gi] - gt[:, 0]) <= 0.5
err = np.linalg.norm(best_path[gi][:, :2] - gt[:, 1:3], axis=1)
err, gi_k, gt_k = err[keep], gi[keep], gt[keep]
if from_frame:
    m = gi_k >= from_frame
    err, gi_k, gt_k = err[m], gi_k[m], gt_k[m]
print(f"per-fix error: p50 {np.percentile(err, 50):.2f} "
      f"p90 {np.percentile(err, 90):.2f} max {err.max():.1f} m")
over = np.nonzero(err > 10.0)[0]
if len(over):
    i = over[0]
    print(f"first >10 m error at t={gt_k[i, 0]:.0f} s (frame {gi_k[i]}), "
          f"err {err[i]:.1f} m; {len(over)}/{len(err)} fixes over 10 m")
else:
    print("no GPS fix error exceeds 10 m — no divergence event")
