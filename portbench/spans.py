"""What the program's own spans and counters say about the traced window: where the host's time went,
and what the host was doing while the card was idle.

The port records spans (``stereo_vision_tpu_torch.utils.profiling.span``: the stream's loader, ring,
staging copy, launch and wait on the card, the decode threads' reads and puts) stamped with
``time.time_ns()``, the clock of ``torch.profiler``'s events, and counts its frame rings' waits
(``profiling.counters()``). ``start`` opens a recording just before the window and ``stop`` closes it
right after; ``summarise`` clips the spans to the window's own span (``portbench.window``), takes the
counters' change, merges the device's busy intervals and splits every idle gap over the consumer thread's
innermost span: a program span, else the harness's ``portbench.next`` (inside the stream's ``next()``
but in no program span), else ``portbench.window`` (the harness's own code). A program without the
recorder gives None.

``harness.py`` does not call this module yet: the lines that would wire it into the traced run, and the
per-layer metrics that would read its figures, are listed in PERF.md (Open questions).
"""

from __future__ import annotations

import bisect
import statistics
import sys
import threading
from collections import defaultdict

from portbench.trace import WINDOW_SPAN

NEXT_SPAN = "portbench.next"
_DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")


def start() -> dict | None:
    """Open a recording of the program's spans on this (the consumer's) thread and read the counters;
    None where the program has no recorder."""
    try:
        from stereo_vision_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not all(hasattr(profiling, a) for a in ("span", "recording", "counters")):
        return None
    ctx = profiling.recording()
    return dict(ctx=ctx, records=ctx.__enter__(), counters=profiling.counters, before=profiling.counters(),
                thread=threading.get_ident())


def stop(handle: dict | None) -> None:
    """Read the counters again and close the recording (once)."""
    if handle is None or "after" in handle:
        return
    handle["after"] = handle["counters"]()
    handle["ctx"].__exit__(None, None, None)


def _busy(events, w0: int, w1: int) -> list[list[int]]:
    """The device's busy intervals in the window: the union of its kernels, copies and memsets."""
    intervals = sorted((max(s, w0), min(e, w1)) for kind, _, s, e in events
                       if kind in _DEVICE and min(e, w1) > max(s, w0))
    merged = [list(intervals[0])] if intervals else []
    for s, e in intervals[1:]:
        if s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _innermost(spans, w0: int, w1: int) -> list[tuple[int, int, str]]:
    """The window cut into (start, end, name) pieces, each named after the innermost of ``spans``
    ((start, end, name) of one thread) open there: the latest started, the shorter on a tie;
    ``portbench.window`` where none is."""
    edges = []
    for i, (s, e, _) in enumerate(spans):
        s, e = max(s, w0), min(e, w1)
        if e > s:
            edges += [(s, 1, i), (e, 0, i)]
    edges.sort()
    out, active, t = [], {}, w0
    for at, opening, i in edges + [(w1, 0, -1)]:
        if at > t:
            inner = max(active.values(), key=lambda sp: (sp[0], -sp[1]), default=(0, 0, WINDOW_SPAN))
            out.append((t, at, inner[2]))
            t = at
        if opening:
            active[i] = spans[i]
        else:
            active.pop(i, None)
    return out


def summarise(events, handle: dict | None) -> dict | None:
    """The program's figures over the window, from the trace's events ((activity type, name, start ns,
    end ns), as ``trace.events_of`` gives them) and a closed recording; None without a recording or
    without the window's span."""
    if handle is None:
        return None
    stop(handle)
    window = [(s, e) for kind, name, s, e in events if kind == "user_annotation" and name == WINDOW_SPAN]
    if not window:
        return None
    w0, w1 = window[0]
    spans_s, spans_n = defaultdict(float), defaultdict(int)
    for r in handle["records"]:
        s, e = max(r.start_ns, w0), min(r.end_ns, w1)
        if e > s:
            spans_s[r.name] += (e - s) * 1e-9
            spans_n[r.name] += 1
    mine = [(r.start_ns, r.end_ns, r.name) for r in handle["records"] if r.thread == handle["thread"]]
    mine += [(s, e, name) for kind, name, s, e in events if kind == "user_annotation" and name == NEXT_SPAN]
    busy = _busy(events, w0, w1)
    bounds = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(a, b) for a, b in zip(bounds[::2], bounds[1::2]) if b > a]
    idle, k = defaultdict(float), 0
    pieces = _innermost(mine, w0, w1)
    for g0, g1 in gaps:  # both sorted and disjoint: walk them together
        while k < len(pieces) and pieces[k][1] <= g0:
            k += 1
        j = k
        while j < len(pieces) and pieces[j][0] < g1:
            p0, p1, name = pieces[j]
            idle[name] += (min(p1, g1) - max(p0, g0)) * 1e-9
            j += 1
    idle_s = sum(idle.values())
    # The wait on the card against the device's clock: each wait over 1 ms should end just after the
    # window's read-back copy (the last device-to-host copy started before the wait ended).
    copies = sorted((s, e) for kind, name, s, e in events if kind == "gpu_memcpy" and "DtoH" in name)
    starts, lags = [c[0] for c in copies], []
    for s, e, name in mine:
        i = bisect.bisect_left(starts, e)
        if name == "stream.card_wait" and e - s > 1_000_000 and w0 <= s and e <= w1 and i:
            lags.append((e - copies[i - 1][1]) * 1e-3)
    counters = {name: v - handle["before"].get(name, 0) for name, v in handle["after"].items()}
    return dict(window_s=(w1 - w0) * 1e-9, spans_s=dict(spans_s), spans_n=dict(spans_n), counters=counters,
                idle_s=dict(sorted(idle.items(), key=lambda kv: -kv[1])), idle_total_s=idle_s,
                coverage=1.0 - idle.get(NEXT_SPAN, 0.0) / idle_s if idle_s else None,
                card_wait_lag_us=dict(n=len(lags), median=statistics.median(lags) if lags else None,
                                      min=min(lags) if lags else None))


def report(summary: dict | None) -> None:
    """One ``spans:`` line: seconds by span (all threads), the counters' change, idle seconds by the
    consumer's innermost span, the share of idle time named by a program span or the harness's own code
    (not ``portbench.next``), and the card waits' lag behind their read-back copies."""
    if summary is None:
        print("spans: the program records none", file=sys.stderr)
        return
    r = lambda d: {k: round(v, 6) for k, v in d.items()}  # noqa: E731
    print(f"spans: total_s {r(summary['spans_s'])} n {summary['spans_n']} counters {summary['counters']} "
          f"idle_s {r(summary['idle_s'])} coverage {summary['coverage']} "
          f"card_wait_lag_us {summary['card_wait_lag_us']}", file=sys.stderr)
