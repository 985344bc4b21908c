"""Host + device memory probes.

Reference: ``MemProfile::get{Peak,Current}RSS`` (include/misc/MemProfile.hpp:
33-52, src/misc/memProfile.cpp).  Adds the device memory numbers from
``Device.memory_stats()`` which the reference (CPU-only) has no analog for.
"""

from __future__ import annotations

import jax


def current_rss() -> int:
    """Current resident set size in bytes (Linux /proc)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    return 0


def peak_rss() -> int:
    """Peak resident set size in bytes (Linux /proc)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmHWM:"):
                return int(line.split()[1]) * 1024
    return 0


def device_memory(device=None) -> dict:
    """HBM usage for one device: {bytes_in_use, peak_bytes_in_use, ...}.

    Returns {} when the backend doesn't expose memory_stats (CPU)."""
    device = device or jax.devices()[0]
    stats = getattr(device, "memory_stats", lambda: None)()
    return dict(stats) if stats else {}


def report() -> str:
    lines = [f"host RSS: {current_rss() / 2**20:.1f} MiB "
             f"(peak {peak_rss() / 2**20:.1f} MiB)"]
    for d in jax.local_devices():
        st = device_memory(d)
        if st:
            lines.append(
                f"{d}: {st.get('bytes_in_use', 0) / 2**20:.1f} MiB in use "
                f"(peak {st.get('peak_bytes_in_use', 0) / 2**20:.1f} MiB)")
    return "\n".join(lines)
