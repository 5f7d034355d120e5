"""Reading a torch.profiler capture of the device: busy time, kernel times by name, the
idle gaps and what the host was doing in each (the method of `profile_render.py`)."""

from __future__ import annotations

import bisect
import time


class Capture:
    """A profiler around a stretch of the run, started and stopped from the run's own
    loop. `sync`: a function that waits for the device."""

    def __init__(self, sync):
        self.sync = sync
        self.prof = None
        self.t0 = self.t1 = 0.0

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.sync()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self) -> dict:
        self.sync()
        self.t1 = time.perf_counter()
        self.prof.stop()
        return summarise(self.prof, self.t1 - self.t0)


def _union(intervals):
    """Merged [start, end) intervals (microseconds), sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarise(prof, window_s: float) -> dict:
    """-> dict(window_s, busy_s, kernels [(name, seconds)], gaps [(label, seconds)])"""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    kern = [(e.time_range.start, e.time_range.end, e.name) for e in events
            if e.device_type == cuda]
    by_name: dict[str, float] = {}
    for s, e, name in kern:
        by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-6
    merged = _union([(s, e) for s, e, _ in kern])
    busy = sum(e - s for s, e in merged) * 1e-6
    # outermost host operations, to name what the host was doing in each idle gap
    cpu = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                 if e.device_type != cuda and getattr(e, "cpu_parent", None) is None)
    starts = [c[0] for c in cpu]
    gaps = []
    for (_, e0), (s1, _) in zip(merged, merged[1:]):
        mid = 0.5 * (e0 + s1)
        i = bisect.bisect_right(starts, mid) - 1
        label = cpu[i][2] if i >= 0 and cpu[i][1] >= mid else "host between operations"
        gaps.append((label, (s1 - e0) * 1e-6))
    gaps.sort(key=lambda g: -g[1])
    return dict(window_s=window_s, busy_s=busy,
                kernels=sorted(by_name.items(), key=lambda kv: -kv[1]), gaps=gaps)


def kernel_seconds(trace: dict, patterns) -> float:
    """Device seconds of the kernels whose name contains any of `patterns`."""
    return sum(t for name, t in trace["kernels"] if any(p in name for p in patterns))


def breakdown(trace: dict) -> dict:
    """The contract's optional `breakdown`: ten costliest device operations and ten
    longest idle gaps by the host's operation."""
    return dict(device_ops=[[n[:120], t] for n, t in trace["kernels"][:10]],
                idle_gaps=[[n[:120], t] for n, t in trace["gaps"][:10]])
