"""What a torch.profiler trace of the measured window says: device time by layer, busy and idle time.

The device's events (kernels, copies, memsets) are clipped to the window's own span
(``portbench.window``) and classed: the port's kernels (the names the ``kernels/*.json`` files list),
copies between host and device, and every other kernel and memset (plain torch). Idle gaps are named by
the innermost host event running in the gap's middle.
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict

WINDOW_SPAN = "portbench.window"
_HOST = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
_DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")


def kernel_base(name: str) -> str:
    """A device kernel's function name: ``void ns::cost_kernel<short, 5>(...)`` -> ``cost_kernel``."""
    head = re.split(r"[<(]", name.removeprefix("void ").replace("(anonymous namespace)::", "").strip(), maxsplit=1)[0]
    return head.rsplit("::", 1)[-1].strip()


_SYNC = ("Stream Wait Event", "Stream Sync", "Event Sync", "Context Sync", "Device Sync")


def _kind(e) -> str:
    """An event's activity type; where torch's event does not say, taken from its device and name."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    name, on_host = e.name(), e.device_type().name == "CPU"
    if name.startswith("portbench.") or (hasattr(e, "is_user_annotation") and e.is_user_annotation()):
        return "user_annotation" if on_host else "gpu_user_annotation"
    if on_host:
        return "cuda_runtime" if name.startswith("cuda") else "cpu_op"
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "cuda_sync" if name.startswith(_SYNC) else "kernel"


def events_of(prof) -> list[tuple[str, str, int, int]]:
    """(activity type, name, start ns, end ns) of every event a finished profiler holds."""
    return [(_kind(e), e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()]


def analyse(events, port_kernels: set[str], top: int = 10) -> dict:
    """Device seconds by class over the window, busy seconds (the union of device events), the window's
    seconds, the top device operations and the idle gaps summed by the host event running at each one's
    middle."""
    spans = [(s, e) for kind, name, s, e in events if kind == "user_annotation" and name == WINDOW_SPAN]
    if not spans:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN} span")
    w0, w1 = spans[0]
    by_class, by_op, intervals = defaultdict(float), defaultdict(float), []
    for kind, name, s, e in events:
        if kind not in _DEVICE:
            continue
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        sec = (e - s) * 1e-9
        if kind == "gpu_memcpy":
            cls, op = "copies", name
        elif kind == "gpu_memset":
            cls, op = "torch_ops", name
        else:
            op = kernel_base(name)
            cls = "kernels" if op in port_kernels else "torch_ops"
        by_class[cls] += sec
        by_op[op] += sec
        intervals.append((s, e))
    if not intervals:
        raise RuntimeError("the trace of the window holds no device activity")
    intervals.sort()
    merged = [list(intervals[0])]
    for s, e in intervals[1:]:
        if s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged) * 1e-9
    gaps = [(w0, merged[0][0])] + [(a[1], b[0]) for a, b in zip(merged, merged[1:])] + [(merged[-1][1], w1)]
    host = sorted((s, e, name) for kind, name, s, e in events if kind in _HOST and name != WINDOW_SPAN)
    starts = [h[0] for h in host]
    idle = defaultdict(float)
    for g0, g1 in gaps:
        if g1 <= g0:
            continue
        mid = (g0 + g1) // 2
        i = bisect.bisect_right(starts, mid)
        name = "host: none"
        for j in range(i - 1, max(i - 400, -1), -1):
            if host[j][1] >= mid:
                name = f"host: {host[j][2]}"
                break
        idle[name] += (g1 - g0) * 1e-9
    rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]  # noqa: E731
    return dict(window_s=(w1 - w0) * 1e-9, busy_s=busy, kernels_s=by_class["kernels"],
                torch_ops_s=by_class["torch_ops"], copies_s=by_class["copies"],
                breakdown=dict(device_ops=rank(by_op), idle_gaps=rank(idle)))
