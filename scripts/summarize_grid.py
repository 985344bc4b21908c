"""Summarize batchsim .dat results into RESULTS.md-style tables.

Usage: python scripts/summarize_grid.py batchResults.dat
Emits one markdown table of median (max) tail pose error and one of median
map COLA, rows = P_D, cols = clutter.  Columns autodetected from the file
(6-column round-3 files lack mapCola).
"""
import sys

import numpy as np


def load(path):
    rows = []
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            rows.append([float(x) for x in line.split()])
    return rows


def main():
    rows = load(sys.argv[1])
    has_map = len(rows[0]) >= 7
    cells = {}
    for r in rows:
        pd, clutter, seed = r[0], r[1], int(r[2])
        cells.setdefault((pd, clutter), []).append(r)
    pds = sorted({k[0] for k in cells}, reverse=True)
    cls = sorted({k[1] for k in cells})

    def table(col, label, fmt="{:.3f}", with_max=True):
        print(f"\n{label}:\n")
        print("| P_D \\ clutter | " + " | ".join(f"{c:g}" for c in cls) + " |")
        print("|---" * (len(cls) + 1) + "|")
        for pd in pds:
            out = [f"| {pd:g} "]
            for c in cls:
                rs = cells.get((pd, c))
                if not rs:
                    out.append("| — ")
                    continue
                v = np.array([r[col] for r in rs])
                cell = fmt.format(np.median(v))
                if with_max:
                    cell += f" ({fmt.format(v.max())}"
                    if len(v) < 5:
                        cell += f", {len(v)} seeds"
                    cell += ")"
                out.append(f"| {cell} ")
            print("".join(out) + "|")

    table(3, "median (max) tail pose error, m")
    if has_map:
        table(5, "median (max) final map COLA error")


if __name__ == "__main__":
    main()
