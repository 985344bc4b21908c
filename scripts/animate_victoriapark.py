#!/usr/bin/env python
"""Animate a Victoria Park run: best-particle trajectory vs GPS + map.

Equivalent of the reference's scripts/VictoriaPark/animate_VictoriaPark.py,
consuming trajectory.dat / particlePose.dat / landmarkEst.dat
(rbphdslam_VictoriaPark.cpp:587-660) plus the dataset's gps.dat.

Usage::

    python scripts/animate_victoriapark.py LOGDIR \
        --gps <VictoriaPark dataset dir>/gps.dat [--save out.mp4]
"""

import argparse
import os

import numpy as np
import matplotlib
import matplotlib.pyplot as plt
from matplotlib import animation


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("logdir")
    ap.add_argument("--gps", required=True, help="the dataset's gps.dat")
    ap.add_argument("--save", default=None)
    ap.add_argument("--stride", type=int, default=5)
    ap.add_argument("--fps", type=int, default=25)
    args = ap.parse_args()
    d = args.logdir
    if args.save:
        matplotlib.use("Agg")

    traj = np.loadtxt(os.path.join(d, "trajectory.dat"))  # t x y th
    le = np.loadtxt(os.path.join(d, "landmarkEst.dat"))
    gps = np.loadtxt(args.gps) if os.path.exists(args.gps) else None

    fig, ax = plt.subplots(figsize=(8, 8))
    ax.set_aspect("equal")
    if gps is not None:
        ax.plot(gps[:, 1], gps[:, 2], ".", ms=1, c="0.7", label="GPS")
    (line,) = ax.plot([], [], "r-", lw=1, label="best particle")
    lms = ax.scatter([], [], marker="+", c="tab:green", s=12, label="map")
    title = ax.set_title("")
    ax.legend(loc="upper right", fontsize=8)
    ax.set_xlim(traj[:, 1].min() - 20, traj[:, 1].max() + 20)
    ax.set_ylim(traj[:, 2].min() - 20, traj[:, 2].max() + 20)

    le_by_t = {}
    for r in le:
        le_by_t.setdefault(round(float(r[0]), 6), []).append(r)
    frames = range(1, len(traj), args.stride)

    def update(k):
        line.set_data(traj[:k, 1], traj[:k, 2])
        t = round(float(traj[k - 1, 0]), 6)
        rows = np.asarray(le_by_t.get(t, np.zeros((0, 8))))
        if len(rows):
            lms.set_offsets(rows[rows[:, 7] >= 0.5][:, 2:4])
        title.set_text(f"t = {traj[k - 1, 0]:.1f}s")
        return [line, lms, title]

    ani = animation.FuncAnimation(fig, update, frames=frames,
                                  interval=1000 // args.fps, blit=False)
    if args.save:
        ani.save(args.save, fps=args.fps)
        print(f"saved {args.save}")
    else:
        plt.show()


if __name__ == "__main__":
    main()
