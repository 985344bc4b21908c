"""Which device a measurement ran on.

Every speed number this repository prints names its device: the JAX
platform, device kind and device count, and the card's name and power limit
as ``nvidia-smi`` reports them (a card set below its maximum power runs
slower under load).
"""

from __future__ import annotations

import subprocess
import sys

import jax


def describe() -> dict:
    """``{"platform", "kind", "count"}`` of the default JAX backend."""
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def nvidia_smi() -> str:
    """``name, power.limit`` of each card, one line per card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def require_gpu(who: str) -> dict:
    """Describe the device; exit non-zero unless JAX's backend is a GPU."""
    dev = describe()
    if dev["platform"] != "gpu":
        print(f"{who}: needs a GPU; JAX found {dev}", file=sys.stderr)
        sys.exit(1)
    dev["nvidia_smi"] = nvidia_smi()
    return dev
