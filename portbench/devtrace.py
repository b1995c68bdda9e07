"""One profiled window on the device, reduced to what the per-layer metrics
read.

The arithmetic follows the program's own chip smoke test (`profile_steps`
of chip_smoke.py): device-side events only, since a host op also carries
the device time of the kernels it launched and would count them twice, and
a kernel's time summed over its template instances.  Beside it, the union of
the device intervals (busy time), and the gaps between them named by the
host op that was running then.
"""
from __future__ import annotations

import bisect
import re
import time
from pathlib import Path

import torch

TOP = 10


def port_kernels(root: Path) -> set:
    """Names of the program's own CUDA kernels: the __global__ functions of
    its sources.  A signature's last identifier before '(' on the
    __global__ line is the kernel's name."""
    names = set()
    for src in sorted((root / "meshdqn_tpu_torch" / "csrc").glob("*.cu")):
        for line in src.read_text().splitlines():
            if line.lstrip().startswith("__global__"):
                found = re.findall(r"(\w+)\s*\(", line)
                if found:
                    names.add(found[-1])
    return names


def is_kernel(event_name: str, kernel: str) -> bool:
    """Whether a device event is an instance of `kernel` (a whole word of
    its demangled name)."""
    return re.search(rf"\b{re.escape(kernel)}\b", event_name) is not None


def _interval(ev):
    tr = ev.time_range
    return float(tr.start), float(tr.end)


def profile(advance, device) -> dict:
    """Profile `advance()` on `device` (host and device activity) and return
    {"window_s", "busy_s", "by_name" (device seconds per event name),
    "device_events", "idle_gaps" ([host op, seconds] of the longest idle
    totals)}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda d: None)
    sync(device)
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        advance()
        sync(device)
        window_s = time.perf_counter() - t0
    dev, host = [], []
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            dev.append((*_interval(ev), ev.name))
        elif ev.device_type == DeviceType.CPU:
            host.append((*_interval(ev), ev.name))
    by_name = {}
    for a, b, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-6
    # Busy: the union of the device intervals.
    dev.sort()
    merged = []
    for a, b, _ in dev:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged) * 1e-6
    return {"window_s": window_s, "busy_s": busy, "by_name": by_name,
            "device_events": len(dev), "idle_gaps": _name_gaps(merged, host)}


def _name_gaps(merged, host) -> list:
    """Idle time between device intervals, summed by the innermost host op
    running at each gap's middle; the TOP largest, in seconds."""
    host.sort()
    starts = [h[0] for h in host]
    totals = {}
    for (_, end), (start, _) in zip(merged, merged[1:]):
        mid = 0.5 * (end + start)
        name = "(no host op)"
        i = bisect.bisect_right(starts, mid) - 1
        # The innermost op holding `mid` is the latest-starting one that
        # has not ended; look back a bounded way among those started.
        for j in range(i, max(i - 256, -1), -1):
            if host[j][1] >= mid:
                name = host[j][2]
                break
        totals[name] = totals.get(name, 0.0) + (start - end) * 1e-6
    return sorted(([k, v] for k, v in totals.items()), key=lambda kv: -kv[1])[:TOP]


def top_ops(by_name: dict) -> list:
    """The TOP device event names by time, [name, seconds]."""
    return sorted(([k[:200], v] for k, v in by_name.items()), key=lambda kv: -kv[1])[:TOP]
