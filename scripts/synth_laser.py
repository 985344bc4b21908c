"""Synthesize a LASER.txt raw-scan stream consistent with measurements.dat.

The usual copy of the Victoria Park dataset ships WITHOUT the raw 361-beam
lidar file, so the measurement model's scan-dependent Pd path — the
trickiest code in MeasurementModel_VictoriaPark (reference:
MeasurementModel_VictoriaPark.cpp:202-265, beam-count Pd table lookup) —
cannot be exercised end-to-end on real data (the reference binary itself
asserts on the missing file, rbphdslam_VictoriaPark.cpp:278-296).

This tool builds a synthetic-but-consistent scan stream: for every Lidar
event, beams default to max range (no return within range), each detection
(r, b, diameter) paints its angular window [b - gamma, b + gamma] with a
return at the tree surface range, and a configurable fraction of beams get a
nearer spurious return so the "obstructed beam" branch (scan value below
range - radius - 0.18) is exercised too.

Beam geometry matches the model: 361 beams over [0, pi], bin k covers
angle k * (2 pi / 720) in the measurement frame (models/victoria_park.py).

Usage::

    python scripts/synth_laser.py --data <VictoriaPark dataset dir> \
        --out <new dir> [--messages 2000] [--obstruct 0.02]

Creates ``out`` with symlinks to the real dataset files plus the synthetic
``LASER.txt``; run the VP apps with ``--data <out>``.
"""

import argparse
import os

import numpy as np


def synthesize(data_dir: str, out_dir: str, messages: int = 0,
               max_range: float = 75.0, obstruct: float = 0.02,
               seed: int = 0) -> str:
    """Build out_dir with dataset symlinks + a synthetic LASER.txt."""
    sm = np.loadtxt(os.path.join(data_dir, "Sensors_manager.txt"))
    meas = np.loadtxt(os.path.join(data_dir, "measurements.dat"))
    if messages:
        sm = sm[:messages]

    z_by_t: dict = {}
    for row in meas:
        z_by_t.setdefault(round(row[0], 6), []).append(row[1:4])

    rng = np.random.default_rng(seed)
    lidar = sm[sm[:, 1] == 3]

    os.makedirs(out_dir, exist_ok=True)
    for name in ("Sensors_manager.txt", "inputs.dat", "measurements.dat",
                 "gps.dat"):
        dst = os.path.join(out_dir, name)
        if not os.path.exists(dst):
            os.symlink(os.path.join(data_dir, name), dst)

    bins_of = lambda a: a * 720.0 / (2.0 * np.pi)
    with open(os.path.join(out_dir, "LASER.txt"), "w") as f:
        for row in lidar:
            t = float(row[0])
            scan = np.full(361, max_range)
            # spurious nearer returns
            n_obs = rng.binomial(361, obstruct)
            idx = rng.integers(0, 361, size=n_obs)
            scan[idx] = rng.uniform(1.0, max_range, size=n_obs)
            for r, b, d in z_by_t.get(round(t, 6), []):
                radius = max(d / 2.0, 0.02)
                gamma = np.arctan(radius / max(r, 0.1))
                lo = int(np.ceil(bins_of(b - gamma)))
                hi = int(np.floor(bins_of(b + gamma)))
                for k in range(lo, hi + 1):
                    if 0 <= k < 361:
                        scan[k] = r  # return at the tree surface
            f.write(" ".join([f"{t:.6f}"] + [f"{v:.3f}" for v in scan]))
            f.write("\n")
    return os.path.join(out_dir, "LASER.txt")


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--data", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--messages", type=int, default=0,
                    help="only synthesize scans for the first N sensor "
                         "messages (0 = all)")
    ap.add_argument("--max-range", type=float, default=75.0)
    ap.add_argument("--obstruct", type=float, default=0.02,
                    help="fraction of beams with a spurious nearer return")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    path = synthesize(args.data, args.out, args.messages, args.max_range,
                      args.obstruct, args.seed)
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
