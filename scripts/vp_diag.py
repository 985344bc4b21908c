"""Victoria Park accuracy diagnostics (developer tool).

Runs the RB-PHD VP app on a message prefix and prints per-segment filter
health: effective sample size, best-particle map size, strong-landmark count
(w >= minWeight, i.e. usable importance-weighting eval points), weight
spread before resampling, and GPS RMSE of the segment.

Run: python scripts/vp_diag.py <VictoriaPark dataset dir> [n_messages]
     [particles]
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from rfs_slam_tpu.apps import rbphdslam_victoriapark as app
from rfs_slam_tpu.io import victoria_park as vp_io
from rfs_slam_tpu.io.xmlconfig import XmlConfig, default_cfg

data_dir = sys.argv[1]
n_msgs = int(sys.argv[2]) if len(sys.argv) > 2 else 15000
n_part = int(sys.argv[3]) if len(sys.argv) > 3 else 100

cfg = XmlConfig(default_cfg("rbphdslam_VictoriaPark.xml"))
filt, input_cov, ack = app.build(cfg, z_capacity=24, map_capacity=512,
                                 n_particles=n_part)
frames = vp_io.load(data_dir,
                    scale_ur=cfg.get("process.ur_scale", 1.0),
                    z_capacity=24, n_messages=n_msgs, ackerman=ack)
F = len(frames.t)
print(f"{F} frames, P={n_part}")
state, outs, wall = app.run(filt, input_cov, frames, seed=0)
poses, weights, best, gm_mean, gm_cov, gm_w, gm_alive, parents = outs

ess = 1.0 / np.maximum(np.sum(weights**2, axis=1), 1e-30)
n_alive = gm_alive.sum(axis=1)
n_strong = ((gm_w >= 0.75) & gm_alive).sum(axis=1)
total_w = np.where(gm_alive, gm_w, 0).sum(axis=1)
resampled = (parents != np.arange(parents.shape[1])[None]).any(axis=1)

from rfs_slam_tpu.io import logs
best_path = logs.ancestral_path(poses, parents, best[-1])

C = max(F // 10, 1)
print(" seg   frames       ESS  map_alive  strong(w>=.75)  sum_w  resamp  rmse_gps")
for s in range(0, F, C):
    e = min(s + C, F)
    sl = slice(s, e)
    rm = app.gps_rmse(frames.t[sl], best_path[sl], frames.gps)
    print(f"{s:5d} {e - s:8d} {ess[sl].mean():9.1f} {n_alive[sl].mean():10.1f} "
          f"{n_strong[sl].mean():15.1f} {total_w[sl].mean():6.1f} "
          f"{resampled[sl].mean():7.2f} {rm:9.2f}")
rmse = app.gps_rmse(frames.t, best_path, frames.gps)
dr = app.gps_rmse(frames.t, frames.dr_pose, frames.gps)
print(f"total RMSE {rmse:.2f} m, dead reckoning {dr:.2f} m, wall {wall:.0f}s")
