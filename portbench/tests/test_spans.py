"""CPU tests of ``portbench/spans.py``: the program's spans and counters reduced over a traced window, on
synthetic events and records, and a real recording of the port's recorder.

Run from the repository root:  python -m pytest portbench/tests -q
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import spans, trace  # noqa: E402


class _Recorded:
    """A closed recording as ``spans.start``/``stop`` leave it, from (name, thread, start, end) spans."""

    def __init__(self, records, before=None, after=None):
        from stereo_vision_tpu_torch.utils.profiling import Span

        self.handle = dict(records=[Span(n, None, t, s, e) for n, t, s, e in records], thread=1,
                           before=before or {"ring.get_wait_ns": 0}, after=after or {"ring.get_wait_ns": 0})


def test_spans_idle_attribution():
    """Each idle gap of the device is split over the consumer's innermost span: a program span, else the
    harness's ``portbench.next``, else ``portbench.window``; decode threads' spans count in the totals only;
    coverage is the idle share not left to ``portbench.next``."""
    window = ("user_annotation", trace.WINDOW_SPAN, 0, 1000)
    nxt = [("user_annotation", spans.NEXT_SPAN, 100, 700)]
    device = [("kernel", "k", 0, 100), ("kernel", "k", 300, 400), ("gpu_memcpy", "Memcpy DtoH", 650, 690),
              ("kernel", "k", 900, 1000)]
    rec = _Recorded([("loader.get", 1, 120, 260), ("loader.read", 2, 100, 200), ("stream.launch", 1, 400, 500),
                     ("stream.card_wait", 1, 600, 695), ("stream.card_wait", 1, 700, 701)],
                    {"ring.get_wait_ns": 5}, {"ring.get_wait_ns": 105})
    out = spans.summarise([window, *nxt, *device], rec.handle)
    # idle [100, 300): next 20, get 140, next 40; [400, 650): launch 100, next 100, wait 50;
    # [690, 900): wait 5, next 5, wait 1, the window 199
    assert out["idle_s"] == pytest.approx({"portbench.next": 165e-9, "loader.get": 140e-9, "stream.launch": 100e-9,
                                           "stream.card_wait": 56e-9, "portbench.window": 199e-9}), out["idle_s"]
    assert out["idle_total_s"] == pytest.approx(660e-9)
    assert out["coverage"] == pytest.approx(1 - 165 / 660)
    assert out["spans_s"]["loader.read"] == pytest.approx(100e-9) and out["spans_n"]["stream.card_wait"] == 2
    assert out["counters"] == {"ring.get_wait_ns": 100}
    assert out["card_wait_lag_us"]["n"] == 0  # no wait lasted over 1 ms
    assert out["window_s"] == pytest.approx(1e-6)


def test_spans_clipped_to_the_window_and_card_wait_lag():
    """Spans are clipped to the window; a card wait over 1 ms is measured from the end of the last
    device-to-host copy started before it ended."""
    ms = 1_000_000
    window = ("user_annotation", trace.WINDOW_SPAN, 10 * ms, 20 * ms)
    device = [("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 12 * ms, 13 * ms),
              ("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 13 * ms, 14 * ms),
              ("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 15 * ms, 16 * ms)]
    rec = _Recorded([("stream.open", 1, 5 * ms, 12 * ms), ("stream.card_wait", 1, 14 * ms, 16 * ms + 30_000),
                     ("stream.close", 1, 19 * ms, 25 * ms)])
    out = spans.summarise([window, *device], rec.handle)
    assert out["spans_s"] == pytest.approx({"stream.open": 2e-3, "stream.card_wait": 2.03e-3, "stream.close": 1e-3})
    assert out["card_wait_lag_us"] == {"n": 1, "median": pytest.approx(30.0), "min": pytest.approx(30.0)}
    assert out["idle_s"]["stream.close"] == pytest.approx(1e-3)


def test_spans_without_the_window_span(capsys):
    """Without the window's span there is nothing to clip to: no figures, and no error."""
    rec = _Recorded([("loader.get", 1, 0, 10)])
    assert spans.summarise([("kernel", "k", 0, 5)], rec.handle) is None
    spans.report(None)
    assert capsys.readouterr().err.startswith("spans: the program records none")


def test_spans_of_a_real_recording(capsys):
    """``start`` opens the port's recorder on this thread and reads its counters, ``stop`` closes it once;
    the spans it holds are summarised and reported on one ``spans:`` line."""
    from stereo_vision_tpu_torch.utils import profiling

    handle = spans.start()
    with profiling.span("loader.get", seq=0):
        w0 = time.time_ns()
    with profiling.span("stream.launch", seq=0):
        pass
    w1 = time.time_ns() + 1_000
    spans.stop(handle)
    spans.stop(handle)
    assert profiling._records is None
    assert [r.name for r in handle["records"]] == ["loader.get", "stream.launch"]
    out = spans.summarise([("user_annotation", trace.WINDOW_SPAN, w0 - 10_000, w1),
                           ("kernel", "k", w0 - 10_000, w0 - 5_000)], handle)
    assert set(out["spans_n"]) == {"loader.get", "stream.launch"} and set(out["counters"]) == set(
        profiling.counters())
    assert 0.0 < out["idle_total_s"] <= out["window_s"]
    spans.report(out)
    line = capsys.readouterr().err.splitlines()
    assert len(line) == 1 and line[0].startswith("spans: ") and "stream.launch" in line[0]


def test_spans_of_a_program_without_the_recorder(monkeypatch):
    """A program that records no spans (an older one) gives no recording and no figures."""
    from stereo_vision_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "recording")
    assert spans.start() is None and spans.summarise([], None) is None
