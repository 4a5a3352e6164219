"""Profiling helpers (the counterpart of ``stereo_vision_tpu/utils/profiling.py``).

- ``time_jitted``: seconds a call over N chained calls, each call's input
  perturbed from the previous call's output, so that no call can be skipped
  or served from a cache and the chain runs in order. On the card it is
  timed with CUDA events around the chain (the host clock would time the
  launches, not the work); on the CPU with the host clock.
- ``trace``: a ``torch.profiler`` context writing a Chrome trace
  (``chrome://tracing``, Perfetto) for per-kernel breakdowns.
- ``StageTimer``: wall-clock per-stage accumulator whose dict plugs into a
  stage report's metrics, so runs report per-stage milliseconds and Mpx/s.
- ``span`` / ``recording``: the program's own spans (the stream's loader,
  ring, staging copy, launch and wait on the card), recorded on any thread
  while a ``recording()`` block is open and free otherwise. A span's times
  are ``time.time_ns()``, the clock of ``torch.profiler``'s events, so the
  spans line up with a device trace taken beside them.
- ``counters``: process-wide totals of the frame ring's waits, always on.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from pathlib import Path
from typing import Callable, NamedTuple

import torch
from torch.utils import _pytree


def time_jitted(
    fn: Callable,
    args: tuple,
    n: int = 5,
    perturb: Callable | None = None,
    reduce_out: Callable | None = None,
) -> float:
    """Seconds per call of ``fn(*args)``, measured as n chained calls after
    one warm-up chain.

    Args:
      fn: function of ``args`` (tensors, or nested tuples, lists and dicts
        of them).
      args: example inputs. Their tensors are copied once, so the default
        perturbation writes to the copies, never to the caller's.
      perturb: ``(flat_args, carry, i) -> flat_args`` hook that must make
        call i's input depend on the previous output ``carry`` (a 0-d
        float32 tensor on the inputs' device) and differ per i. Default:
        add ``carry + i`` (cast to the tensor's dtype) to the first element
        of the first non-bool tensor, in place.
      reduce_out: ``out -> carry`` from fn's output. Default: the first
        tensor's centre element as float32 (borders are often constant,
        e.g. SGBM's invalid margin).

    Times with CUDA events where the first input tensor is on a CUDA device,
    else with the host clock.
    """
    flat, spec = _pytree.tree_flatten(args)
    flat = [a.clone() if isinstance(a, torch.Tensor) else a for a in flat]
    tensors = [a for a in flat if isinstance(a, torch.Tensor)]
    if not tensors:
        raise ValueError("time_jitted needs at least one tensor input")
    device = tensors[0].device

    def default_perturb(fl, carry, i):
        # Perturb the first non-bool tensor (a bool has no meaningful
        # "+bump": adding saturates).
        for a in fl:
            if isinstance(a, torch.Tensor) and a.dtype != torch.bool:
                a[(0,) * a.ndim] += (carry + i).to(a.dtype)
                return fl
        raise ValueError(
            "all inputs are boolean; pass an explicit perturb= hook so each "
            "iteration's input depends on the previous output"
        )

    def default_reduce(out):
        leaf = next(t for t in _pytree.tree_leaves(out) if isinstance(t, torch.Tensor))
        return leaf[tuple(s // 2 for s in leaf.shape)].to(torch.float32)

    perturb_flat = perturb or default_perturb
    reduce_fn = reduce_out or default_reduce

    def chained():
        carry = torch.zeros((), dtype=torch.float32, device=device)
        for i in range(n):
            fl = perturb_flat(list(flat), carry, i)
            carry = reduce_fn(fn(*_pytree.tree_unflatten(fl, spec)))
        return carry

    if device.type == "cuda":
        chained()  # build + warm
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        chained()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / n
    float(chained())  # warm
    t0 = time.perf_counter()
    float(chained())
    return (time.perf_counter() - t0) / n


class Span(NamedTuple):
    """One recorded span: ``seq`` is the stream window's sequence number
    (None where there is none), ``clip`` "left" or "right" on a decode
    thread, ``thread`` the ``threading.get_ident()`` of the thread it ran
    on; the times are Unix-epoch nanoseconds. Spans of one thread nest."""

    name: str
    seq: int | None
    thread: int
    start_ns: int
    end_ns: int
    clip: str | None = None


_records: list[Span] | None = None  # the open recording's list; None: recording is off
_thread_names: dict[int, str] = {}  # the threads' names, for the Chrome trace


_OFF = contextlib.nullcontext()  # the span of a recording that is off: nothing read, nothing kept


class _On:
    __slots__ = ("out", "name", "seq", "clip", "start")

    def __init__(self, out: list, name: str, seq, clip):
        self.out, self.name, self.seq, self.clip = out, name, seq, clip

    def __enter__(self):
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        if self.out is _records:  # a span still open when its recording ended is dropped
            thread = threading.get_ident()  # reused by a later thread: its name is the latest
            _thread_names[thread] = threading.current_thread().name
            self.out.append(Span(self.name, self.seq, thread, self.start, end, self.clip))
        return False


def span(name: str, seq: int | None = None, clip: str | None = None):
    """``with span("stream.launch", seq): ...`` records the block's start
    and end while a :func:`recording` is open. Off, it returns one shared
    object that does nothing: no allocation and no clock read."""
    out = _records
    if out is None:
        return _OFF
    return _On(out, name, seq, clip)


@contextlib.contextmanager
def recording():
    """Record every :func:`span` entered on any thread while the block runs;
    yields the list the spans are appended to as they end. A recording
    opened inside another takes the spans until it closes."""
    global _records
    prev, out = _records, []
    _records = out
    try:
        yield out
    finally:
        _records = prev


def counters() -> dict[str, int]:
    """Process-wide totals since the process started: ``ring.put_wait_ns``
    and ``ring.puts`` (a producer waiting for a free slot of a frame ring,
    and its puts), ``ring.get_wait_ns`` and ``ring.gets`` (a consumer
    waiting for a filled slot, and its gets), over every ring, closed ones
    too (``io.loader.ring_counters``)."""
    from stereo_vision_tpu_torch.io import loader

    return {f"ring.{k}": v for k, v in loader.ring_counters().items()}


def _chrome_events(spans: list[Span], base_ns: int) -> list[dict]:
    """The spans as Chrome trace events in microseconds from ``base_ns`` (the
    ``baseTimeNanoseconds`` of ``torch.profiler``'s export), one track a
    thread, named after the thread."""
    pid = "program spans"
    out = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid, "args": {"name": _thread_names[tid]}}
           for tid in sorted({s.thread for s in spans})]
    for s in spans:
        args = {k: v for k, v in (("seq", s.seq), ("clip", s.clip)) if v is not None}
        out.append({"ph": "X", "name": s.name, "pid": pid, "tid": s.thread, "ts": (s.start_ns - base_ns) / 1e3,
                    "dur": (s.end_ns - s.start_ns) / 1e3, "args": args})
    return out


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler trace of the block (CPU, and the card's kernels where
    there is one), written as a Chrome trace to ``log_dir/trace.json`` with
    the program's spans of the block (:func:`span`) on tracks of their own;
    the profiler is yielded for ``key_averages()``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with recording() as spans, profile(activities=activities) as prof:
        yield prof
    path = out / "trace.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    doc.setdefault("traceEvents", []).extend(_chrome_events(spans, int(doc.get("baseTimeNanoseconds", 0))))
    path.write_text(json.dumps(doc))


class StageTimer:
    """Accumulates named wall-clock stage timings.

    >>> t = StageTimer()
    >>> with t("rectify"): ...
    >>> t.metrics  # {"rectify_ms": ...}
    """

    def __init__(self):
        self._ms: dict[str, float] = {}
        self._px: dict[str, int] = {}

    @contextlib.contextmanager
    def __call__(self, name: str, pixels: int | None = None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self._ms[f"{name}_ms"] = self._ms.get(f"{name}_ms", 0.0) + dt * 1e3
            if pixels:
                # Accumulate pixels alongside time so a reused stage name
                # reports throughput over ALL its intervals, not the last.
                self._px[name] = self._px.get(name, 0) + pixels

    @property
    def metrics(self) -> dict[str, float]:
        out = dict(self._ms)
        for name, px in self._px.items():
            out[f"{name}_mpx_per_s"] = px / self._ms[f"{name}_ms"] / 1e3
        return out
