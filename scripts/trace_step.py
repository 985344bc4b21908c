"""Profile a warm window of a 2-D sim filter scan on one GPU.

``--filter rbphd`` (default) builds the bench workload (bench.py: 200
particles, map capacity 128, measurement capacity 40); ``fastslam`` and
``mhfastslam`` build the fastslam2dsim app's filter from cfg/*.xml at its
full widths.  The script runs the first ``--warm`` steps to reach a mid-run
state, then times and traces one ``--window``-step scan with
``jax.profiler``.  The trace is reduced to, per filter phase (the
``jax.named_scope`` labels of filters/rbphd.py — map_update, importance,
merge, prune, resample — and filters/fastslam.py — da_table, assignment,
apply, candidates; everything else is "other"):

* device time per step and kernel launches per step;
* bytes each kernel reads and writes (operand and result shapes of its HLO
  instruction), and the phase's time at the 3.35 TB/s HBM bound of an H100
  SXM (NVIDIA data sheet) against its measured time;

plus the device busy time and idle share of the window.  Writes the
summary to ``chiprun_out/trace_step.json`` and prints it.

Run: python scripts/trace_step.py [--filter rbphd] [--warm 300] [--window 50]
"""

import argparse
import collections
import glob
import json
import os
import re
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rfs_slam_tpu.utils import cache  # noqa: E402

cache.enable()

import jax  # noqa: E402
import numpy as np  # noqa: E402

import bench  # noqa: E402
from rfs_slam_tpu.utils import device  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
SCOPES = ("map_update", "importance", "merge", "prune", "resample",
          "da_table", "assignment", "apply", "candidates")
_DTYPE_BYTES = {"f32": 4, "s32": 4, "u32": 4, "pred": 1, "f64": 8,
                "s64": 8, "u64": 8, "f16": 2, "bf16": 2, "s8": 1, "u8": 1,
                "s16": 2, "u16": 2}
_SHAPE_RE = re.compile(r"\b(f32|s32|u32|pred|f64|s64|u64|f16|bf16|s8|u8|"
                       r"s16|u16)\[([0-9,]*)\]")
_INSTR_RE = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*(.*)$")
_OPNAME_RE = re.compile(r'op_name="([^"]*)"')


def hlo_index(hlo_text):
    """instruction name -> (op_name metadata, bytes of result + operands)."""
    out = {}
    for line in hlo_text.splitlines():
        m = _INSTR_RE.match(line)
        if not m:
            continue
        name, rest = m.groups()
        body = rest.split(", metadata=")[0]
        nbytes = 0
        for dt, dims in _SHAPE_RE.findall(body):
            n = 1
            for d in filter(None, dims.split(",")):
                n *= int(d)
            nbytes += n * _DTYPE_BYTES[dt]
        op = _OPNAME_RE.search(rest)
        # kernels are named after their instruction with '.' -> '_'
        out[name] = out[name.replace(".", "_")] = (
            op.group(1) if op else "", nbytes)
    return out


def scope_of(op_name):
    for s in SCOPES:
        if f"/{s}/" in op_name or op_name.endswith(f"/{s}"):
            return s
    return "other"


def device_events(trace_dir):
    from jax.profiler import ProfileData

    path = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                     recursive=True)[0]
    data = ProfileData.from_file(path)
    events, host = [], []
    for plane in data.planes:
        if plane.name.startswith("/device:GPU:0"):
            for line in plane.lines:
                for ev in line.events:
                    events.append((line.name, ev.name, ev.start_ns,
                                   ev.duration_ns, dict(ev.stats)))
        elif plane.name.startswith("/host:"):
            for line in plane.lines:
                for ev in line.events:
                    if ev.name == "trace_window":
                        host.append((ev.start_ns, ev.duration_ns))
    return events, host


def busy_ns(intervals):
    total, end = 0.0, -np.inf
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def build(kind):
    """(sim_cfg, data, filter) of the bench or of the fastslam2dsim app."""
    if kind == "rbphd":
        return bench.build()
    from rfs_slam_tpu.apps import fastslam2dsim
    from rfs_slam_tpu.io import sim2d
    from rfs_slam_tpu.io.xmlconfig import XmlConfig, default_cfg, load_sim2d

    cfg = XmlConfig(default_cfg(f"{kind}2dSim.xml"))
    sim_cfg = load_sim2d(cfg)
    data = sim2d.generate(sim_cfg, traj_seed=0, noise_seed=0)
    filt = fastslam2dsim.build_filter_from_xml(
        cfg, sim_cfg, z_capacity=max(data.z.shape[1], 4))
    return sim_cfg, data, filt


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--filter", default="rbphd",
                    choices=["rbphd", "fastslam", "mhfastslam"])
    ap.add_argument("--warm", type=int, default=300)
    ap.add_argument("--window", type=int, default=50)
    ap.add_argument("--out", default="chiprun_out/trace_step.json")
    args = ap.parse_args()
    dev = device.require_gpu("trace_step")
    print(f"trace_step: {dev}", flush=True)

    sim_cfg, data, filt = build(args.filter)
    inputs = bench.scan_inputs(data.odometry, data.z, data.z_mask,
                               data.gt_pose)
    W = args.window
    state = filt.init_state(jax.random.PRNGKey(0), jax.numpy.zeros(3))
    sl = lambda t: jax.tree_util.tree_map(lambda a: a[t:t + W], inputs)
    compiled = jax.jit(bench.make_run(filt, sim_cfg.dt)).lower(
        state, sl(0)).compile()
    for t in range(0, args.warm, W):
        state, _ = compiled(state, sl(t))
    state = jax.block_until_ready(state)
    win = sl(args.warm)
    times = [bench.timed(compiled, state, win)[0] for _ in range(5)]
    ms_step = 1e3 * float(np.median(times)) / W

    trace_dir = tempfile.mkdtemp(prefix="trace_step_")
    with jax.profiler.trace(trace_dir):
        with jax.profiler.TraceAnnotation("trace_window"):
            jax.block_until_ready(compiled(state, win))
    events, host = device_events(trace_dir)
    index = hlo_index(compiled.as_text())

    kernels = [e for e in events if "memcpy" not in e[1].lower()]
    per = collections.defaultdict(lambda: [0.0, 0, 0])
    unmapped = collections.Counter()
    top = collections.Counter()
    for line, name, start, dur, stats in kernels:
        key = str(stats.get("hlo_op", name))
        op_name, nbytes = index.get(key, index.get(name, ("", 0)))
        if not op_name:
            unmapped[name] += dur
        sc = scope_of(op_name or str(stats.get("tf_op", "")))
        per[sc][0] += dur
        per[sc][1] += 1
        per[sc][2] += nbytes
        top[(sc, name)] += dur
    busy = busy_ns([(s, s + d) for _, _, s, d, _ in events])
    span = (max(s + d for _, _, s, d, _ in events)
            - min(s for _, _, s, d, _ in events))
    host_ns = host[0][1] if host else None

    summary = {
        "filter": args.filter,
        "device": dev,
        "window_steps": W,
        "warm_steps": args.warm,
        "untraced_ms_per_step_median_of_5": ms_step,
        "traced_host_window_ms": host_ns / 1e6 if host_ns else None,
        "device_busy_ms": busy / 1e6,
        "device_event_span_ms": span / 1e6,
        "idle_share_of_host_window": (1 - busy / host_ns) if host_ns
        else None,
        "idle_share_of_device_span": 1 - busy / span,
        "n_device_events": len(events),
        "phases": {
            sc: {
                "device_ms_per_step": v[0] / 1e6 / W,
                "kernels_per_step": v[1] / W,
                "hlo_bytes_per_step": v[2] / W,
                "hbm_bound_ms_per_step": v[2] / W / HBM_BYTES_PER_S * 1e3,
                "share_of_hbm_bound": (v[2] / HBM_BYTES_PER_S)
                / (v[0] / 1e9) if v[0] else None,
            } for sc, v in sorted(per.items())},
        "top_kernels_ms_per_step": [
            (sc, name, d / 1e6 / W) for (sc, name), d in top.most_common(25)],
        "unmapped_kernels_ms": [(n, d / 1e6) for n, d in
                                unmapped.most_common(10)],
        "event_stat_keys": sorted({k for *_, st in events[:200]
                                   for k in st}),
        "sample_events": [(ln, n, d, {k: str(v)[:120] for k, v in
                                      st.items()})
                          for ln, n, _, d, st in events[:5]],
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=1, default=str)
    print(json.dumps(summary, indent=1, default=str))


if __name__ == "__main__":
    main()
