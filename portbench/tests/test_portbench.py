"""CPU tests of the port's benchmark harness: tiny cells end to end on the plain forms, the check's faults
and control, discovery by name, the frozen bound arithmetic, the trace reduction and the import rule.

Run from the repository root:  python -m pytest portbench/tests -q
"""

from __future__ import annotations

import ast
import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import control, harness, roofline, trace  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
# The hierarchical configuration's files are kept for a later cell (PERF.md, Open questions); the tests
# add its cells to a copy of BENCHMARK.json, as a later change would.
HIER = {"config": {"name": "hier4_720p", "source": "Rothermel et al. 2012, SURE",
                   "file": "portbench/configs/hier4_720p.json", "reduced": [], "why": "hierarchical SGBM"},
        "cells": [{"name": f"hier4_720p.{t}", "config": "hier4_720p", "traffic": t, "chips": 1, "why": t}
                  for t in ("stats32", "full32")]}
CELLS = [w["name"] for w in BENCH["workloads"]] + [c["name"] for c in HIER["cells"]]
CONFIGS = [c["name"] for c in BENCH["configs"]] + [HIER["config"]["name"]]
TINY = dict(height=48, width=192, clip_frames=64)  # D = 128 leaves 64 valid columns; two windows of 32


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    """A checkout's benchmark files with every configuration cut to 48x192, 64 frames."""
    bench = {**BENCH, "configs": BENCH["configs"] + [HIER["config"]], "workloads": BENCH["workloads"] + HIER["cells"]}
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for c in bench["configs"]:
        p = tmp_path / c["file"]
        p.write_text(json.dumps({**json.loads(p.read_text()), **TINY}))
    return tmp_path


def run(root: Path, cell: str, seed: int = 2**31 + 5) -> dict:
    return harness.run_cell(root, cell, seed, 0.2, False, torch.device("cpu"), harness.process_start())


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_cell_end_to_end(tiny_root, cell):
    r = run(tiny_root, cell)
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {m["name"] for m in BENCH["end_to_end"]}
    assert r["attempted"] >= TINY["clip_frames"] and r["failed"] == 0
    assert all(c["value"] == 0 for c in r["checks"].values())
    assert list(r)[-1] == "checks"


def _alter_stats(monkeypatch):
    from stereo_vision_tpu_torch.parallel import streaming
    orig = streaming._frame_stats
    monkeypatch.setattr(streaming, "_frame_stats", lambda d, p: orig(d, p) + torch.tensor([1e-3, 0.0]))


def _alter_disparity(monkeypatch):
    from stereo_vision_tpu_torch.parallel import streaming
    orig = streaming.reproject_disparity_to_3d
    monkeypatch.setattr(streaming, "reproject_disparity_to_3d", lambda d, Q: orig(d + 0.0625 * (d > 0), Q))


def _half_batch(monkeypatch):
    """Each window leaves out its second half: the first half's frames are computed in its place."""
    from stereo_vision_tpu_torch.parallel import streaming
    orig = streaming.batched_stereo_pipeline

    def half(left, right, *a, **kw):
        h = left.shape[0] // 2
        return orig(torch.cat([left[:h], left[:h]]), torch.cat([right[:h], right[:h]]), *a, **kw)

    monkeypatch.setattr(streaming, "batched_stereo_pipeline", half)


def _window_lost(monkeypatch):
    """The stream's last window never comes."""
    orig = harness.Program.__init__

    def init(self, *a, **kw):
        orig(self, *a, **kw)
        stream = self.stream_video_pair

        def lossy(*args, **kwargs):
            items = list(stream(*args, **kwargs))
            yield from items[:-1]

        self.stream_video_pair = lossy

    monkeypatch.setattr(harness.Program, "__init__", init)


FAULTS = {"answer_altered": _alter_stats, "disparity_altered": _alter_disparity, "half_batch": _half_batch,
          "window_lost": _window_lost}


@pytest.mark.parametrize("cell, fault", [(c, f) for c in ("hier4_720p.stats32", "hier4_720p.full32") for f in FAULTS
                                         if not (c.endswith("full32") and f == "answer_altered")])
def test_faults_make_the_run_incorrect(tiny_root, monkeypatch, cell, fault):
    t = tiny_root / "portbench" / "traffic" / f"{cell.split('.')[1]}.json"
    t.write_text(json.dumps({**json.loads(t.read_text()), "check_frames": 8}))
    FAULTS[fault](monkeypatch)
    r = run(tiny_root, cell)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("config", CONFIGS)
def test_control_fails_the_limits(tiny_root, config):
    """The reference in bfloat16 in the program's place reads above a limit, stats and full alike."""
    cfg = json.loads((ROOT / f"portbench/configs/{config}.json").read_text())
    r = control.readings(tiny_root, config, 3, 4, torch.device("cpu"))
    assert any(r[k] > cfg["limits"][k] for k in ("valid_gap", "depth_gap")), r
    assert any(r[k] > cfg["limits"][k] for k in ("disp_mismatch", "points_gap")), r


def test_every_file_is_found_by_name():
    for cell in [w["name"] for w in BENCH["workloads"]]:
        spec = harness.load_cell(ROOT, cell)
        assert spec["config"]["matcher"] in ("sgbm", "sgbm_hier")
        assert {"window", "stats_only", "check_frames"} <= set(spec["traffic"])
        for m in spec["end_to_end"] + spec["per_layer"]:
            assert callable(harness.metric_reader(spec["dir"], m["name"]))
    import importlib
    for name, k in harness.port_kernels(ROOT / "portbench").items():
        assert callable(getattr(importlib.import_module(k["module"]), k["attr"])), name
        assert k["device_kernels"]


def test_a_new_cell_takes_only_new_files(tiny_root):
    """A configuration, a traffic mix and a metric added as files and entries run without an edit."""
    pb = tiny_root / "portbench"
    cfg = json.loads((pb / "configs/hier4_720p.json").read_text())
    (pb / "configs/hier4_narrow.json").write_text(json.dumps({**cfg, "width": 160}))
    (pb / "traffic/stats32x.json").write_text(json.dumps({"window": 32, "stats_only": True, "check_frames": 2}))
    (pb / "metrics/windows_total.py").write_text("def read(run):\n    return float(run['windows'])\n")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["configs"].append({**HIER["config"], "name": "hier4_narrow", "file": "portbench/configs/hier4_narrow.json",
                             "reduced": ["width"]})
    bench["workloads"].append({"name": "hier4_narrow.stats32x", "config": "hier4_narrow", "traffic": "stats32x",
                               "chips": 1, "why": "a test cell"})
    bench["end_to_end"].append({"name": "windows_total", "unit": "windows", "better": "higher", "bound": 0.05,
                                "source": "host_clock", "workloads": ["hier4_narrow.stats32x"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    r = run(tiny_root, "hier4_narrow.stats32x")
    assert r["correct"], r["checks"]
    assert r["metrics"]["windows_total"]["value"] >= 2
    assert "windows_total" not in run(tiny_root, "hier4_720p.stats32")["metrics"]


def test_frozen_bounds_give_chip_smokes_numbers():
    """#1 (cost) and #4 (wta4) of PERF's kernel table, exact8's 4 frames at 1280x720, D=128: 0.262 and
    1.035 ms (both by bytes)."""
    meta = dict(device="meta")
    img = torch.empty((4, 720, 1280), dtype=torch.int32, **meta)
    vol = torch.empty((4, 720, 1152, 128), dtype=torch.int16, **meta)
    b, o = roofline.call_bound("cost", (img, img), dict(ndisp=128, mindisp=0, block_size=5, ftzero=15,
                                                         x_offset=128, dtype=torch.int16), vol)
    assert roofline.bound_ms(b, o) == (pytest.approx(0.2624, abs=5e-4), "bytes")
    maps = tuple(torch.empty((4, 720, 1152), dtype=torch.int32, **meta) for _ in range(5))
    uok = torch.empty((4, 720, 1152), dtype=torch.bool, **meta)
    b, o = roofline.call_bound("wta4", ([vol] * 4, 10), {}, (*maps, uok))
    assert roofline.bound_ms(b, o) == (pytest.approx(1.035, abs=5e-4), "bytes")


FORBIDDEN = {"jax", "jaxlib", "flax", "stereo_vision_tpu"}


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module" and node.args:
            if isinstance(node.args[0], ast.Constant):
                names.add(node.args[0].value.split(".")[0])
    return names


def test_nothing_imports_jax_or_the_jax_package(monkeypatch):
    for path in (ROOT / "portbench").rglob("*.py"):
        assert not _imports(path) & FORBIDDEN, path
    for path in (ROOT / "portbench" / "reference").glob("*.py"):  # the reference takes nothing of the program
        assert "stereo_vision_tpu_torch" not in _imports(path), path
    for c in BENCH["configs"]:
        mod = json.loads((ROOT / c["file"]).read_text())["matcher_reference"]
        assert mod.split(".")[0] == "portbench"
    # the run's own look at sys.modules compares whole top-level names
    monkeypatch.setitem(sys.modules, "stereo_vision_tpu_torchx", sys)
    assert not [m for m in harness.forbidden_modules() if m.startswith("stereo_vision_tpu_torch")]
    monkeypatch.setitem(sys.modules, "stereo_vision_tpu.stereo", sys)
    assert "stereo_vision_tpu.stereo" in harness.forbidden_modules()


def _events(device):
    w = ("user_annotation", trace.WINDOW_SPAN, 0, 1000)
    host = [("cpu_op", "aten::copy_", 100, 400), ("cuda_runtime", "cudaEventSynchronize", 600, 900)]
    return [w, *host, *device]


def test_trace_reduction():
    dev = [("kernel", "void (anonymous namespace)::cost_kernel<short, 5>(int const*)", 0, 200),
           ("kernel", "void at::native::vectorized_elementwise_kernel<4>(int)", 150, 300),
           ("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 500, 600),
           ("gpu_memset", "Memset (Device)", 950, 1200)]
    r = trace.analyse(_events(dev), {"cost_kernel"})
    assert r["window_s"] == pytest.approx(1e-6)
    assert r["busy_s"] == pytest.approx(4.5e-7)  # [0, 300] + [500, 600] + [950, 1000]
    assert (r["kernels_s"], r["torch_ops_s"], r["copies_s"]) == pytest.approx((2e-7, 2e-7, 1e-7))
    assert r["breakdown"]["idle_gaps"][0] == ["host: cudaEventSynchronize", pytest.approx(3.5e-7)]
    assert r["breakdown"]["idle_gaps"][1] == ["host: aten::copy_", pytest.approx(2e-7)]
    assert r["breakdown"]["device_ops"][0][0] == "cost_kernel"


def test_a_trace_without_device_activity_fails():
    with pytest.raises(RuntimeError, match="no device activity"):
        trace.analyse(_events([]), {"cost_kernel"})


def test_configs_are_the_programs_settings():
    from stereo_vision_tpu_torch.stereo.hier import HIER4_FAST
    from stereo_vision_tpu_torch.stereo.sgbm import StereoSGBMParams
    hier = json.loads((ROOT / "portbench/configs/hier4_720p.json").read_text())
    exact = json.loads((ROOT / "portbench/configs/sgbm8_720p.json").read_text())
    assert {**hier["hier"], "mid_levels": ()} == HIER4_FAST._asdict()
    want = StereoSGBMParams(num_disparities=128, block_size=5, uniqueness_ratio=10, disp12_max_diff=1,
                            speckle_window_size=100, speckle_range=2)
    assert exact["params"] == want._asdict()
    assert hier["params"] == want._replace(num_paths=3)._asdict()


def test_traced_run_reads_every_per_layer_metric(tiny_root, monkeypatch):
    """The traced path on the CPU: the profiler's own events plus one device kernel of the port inside the
    window (the CPU has none), the bound recorded from a recording's wrapper calls."""
    real = trace.events_of

    def with_a_kernel(prof):
        events = real(prof)
        w0, w1 = next((s, e) for k, n, s, e in events if n == trace.WINDOW_SPAN)
        return events + [("kernel", "void banded_cost_kernel<4>(int)", w0, (w0 + w1) // 2)]

    monkeypatch.setattr(trace, "events_of", with_a_kernel)
    r = harness.run_cell(tiny_root, "hier4_720p.stats32", 7, 0.2, True, torch.device("cpu"), harness.process_start())
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {m["name"] for m in BENCH["per_layer"]}
    assert 0 < r["metrics"]["kernels.roofline_pct"]["value"]
    assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
    assert r["breakdown"]["device_ops"][0][0] == "banded_cost_kernel"
