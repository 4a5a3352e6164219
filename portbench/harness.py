"""One run of one cell: set-up, the measured window through ``stream_video_pair``, the check, the result.

Everything is found by name: the cell in ``BENCHMARK.json``, its configuration's file, its traffic mix
in ``traffic/<traffic>.json``, each metric's reader in ``metrics/<metric>.py`` and the port's kernel
wrappers in ``kernels/*.json``. A later cell, mix, metric or kernel is a new file and a new entry.

Set-up (``setup_s``, from the process's start): the rig's maps and Q in numpy, the clip rendered on the
device and written as two raw Y800 AVI files into the run's temporary directory, and one warm-up clip
through the stream (the first run in a checkout builds the kernels there). The window streams the clip
again and again, one ``stream_video_pair`` call a recording, until ``--seconds`` are up. Afterwards the
frames that a sample drawn from the seed names are held to the plain reference (``reference/``), which
reads the same files and gets the same maps and Q.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from portbench import avi, rig, roofline, scene, trace
from portbench.reference import pipeline as reference

BENCH_DIR = "portbench"  # the benchmark's files, under the checkout's root
FORBIDDEN = ("jax", "jaxlib", "flax", "stereo_vision_tpu")


def process_start() -> float:
    """time.time() at which this process started (Linux), else now."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


def load_cell(root: Path, name: str) -> dict:
    """The cell's entry, its configuration (entry and file), its traffic mix and the metrics it reports."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg = json.loads((root / entry["file"]).read_text())
    traffic = json.loads((root / BENCH_DIR / "traffic" / f"{cell['traffic']}.json").read_text())

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return dict(cell=cell, config=cfg, traffic=traffic, end_to_end=mine(bench["end_to_end"]),
                per_layer=mine(bench["per_layer"]), dir=root / BENCH_DIR)


def metric_reader(bench_dir: Path, name: str):
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}",
                                                  bench_dir / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def port_kernels(bench_dir: Path) -> dict[str, dict]:
    return {p.stem: json.loads(p.read_text()) for p in sorted((bench_dir / "kernels").glob("*.json"))}


def forbidden_modules() -> list[str]:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


class Program:
    """The system under test: ``stream_video_pair`` of the port on a 1x1 mesh of ``device``."""

    def __init__(self, cfg: dict, traffic: dict, device: torch.device, maps, Q, paths):
        from stereo_vision_tpu_torch.parallel.mesh import create_mesh
        from stereo_vision_tpu_torch.parallel.streaming import stream_video_pair
        from stereo_vision_tpu_torch.stereo.hier import HierParams
        from stereo_vision_tpu_torch.stereo.sgbm import StereoSGBMParams

        self.stream_video_pair = stream_video_pair
        self.mesh = create_mesh(1, 1) if device.type == "cuda" else create_mesh(1, 1, devices=[device])
        self.params = StereoSGBMParams(**cfg["params"])
        self.hier = None if cfg.get("hier") is None else HierParams(**{
            k: tuple(tuple(lv) for lv in v) if k == "mid_levels" else v for k, v in cfg["hier"].items()})
        # The maps and Q live on the device, as the stream CLI passes them.
        self.maps = tuple(torch.as_tensor(m, device=device) for m in maps)
        self.Q = torch.as_tensor(Q, device=device)
        self.matcher, self.paths = cfg["matcher"], paths
        self.window, self.stats_only = traffic["window"], traffic["stats_only"]

    def recording(self, keep=None) -> dict:
        """One call of ``stream_video_pair`` over the clip, consumed to its end: the waits in ``next()``
        (the first counted from the call), frames and windows returned, and the outputs ``keep(frame)``
        asks for, copied."""
        waits, frames, windows, kept, seqs = [], 0, 0, {}, []
        t = time.perf_counter()
        gen = self.stream_video_pair(*self.paths, self.mesh, self.maps, self.Q, self.matcher, self.params,
                                     self.hier, window=self.window, stats_only=self.stats_only)
        try:
            while True:
                with torch.profiler.record_function("portbench.next"):
                    try:
                        seq, out, pts, n_valid = next(gen)
                    except StopIteration:
                        break
                now = time.perf_counter()
                waits.append(now - t)
                seqs.append(seq)
                windows += 1
                frames += int(n_valid)
                if keep is not None:
                    for k in range(int(n_valid)):
                        f = seq * self.window + k
                        if keep(f):
                            kept[f] = (out[k].copy(), None if pts is None else pts[k].copy())
                t = time.perf_counter()
        finally:
            gen.close()
        return dict(waits=waits, frames=frames, windows=windows, kept=kept, seqs=seqs)


def record_bounds(program: Program, kernels: dict[str, dict]) -> float:
    """The bound in seconds of one recording's port kernels: each kernel wrapper that the ``kernels/*.json``
    files name is swapped, wherever the port's modules hold it, for one that records its arguments, for one
    call of the stream; bytes and operations are summed a wrapper, then bounded."""
    saved, sums = [], {}
    for name, k in kernels.items():
        fn = getattr(importlib.import_module(k["module"]), k["attr"])

        def wrapper(*args, _name=name, _fn=fn, **kwargs):
            out = _fn(*args, **kwargs)
            b, o = roofline.call_bound(_name, args, kwargs, out)
            acc = sums.setdefault(_name, [0.0, 0.0])
            acc[0], acc[1] = acc[0] + b, acc[1] + o
            return out

        for attr, v in vars(fn).items():  # the wrapped function counts its launches on this name
            setattr(wrapper, attr, 0 if isinstance(v, int) else v)
        for mod in [m for n, m in list(sys.modules.items()) if n.split(".")[0] == "stereo_vision_tpu_torch"]:
            for attr, v in list(vars(mod).items()):
                if v is fn:
                    saved.append((mod, attr, fn))
                    setattr(mod, attr, wrapper)
    try:
        program.recording()
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    return sum(roofline.bound_ms(b, o)[0] for b, o in sums.values()) * 1e-3


def compare(recs: list[dict], ref: dict, stats_only: bool, n_frames: int, limits: dict) -> dict:
    """The numbers compared, each with its limit: stats cells the largest gap of a frame's valid share
    (absolute) and median depth (relative) over every sampled frame of every recording; full cells the
    largest share of a kept frame's pixels whose disparity differs and the largest gap of a point's
    coordinate relative to the reference's (|p - r| / (|r| + 1 mm)); both the frames never returned."""
    missing, gaps = 0, {}
    for rec in recs:
        missing += n_frames - rec["frames"]
        if rec["seqs"] != list(range(len(rec["seqs"]))):
            missing += n_frames
        for f, (out, pts) in rec["kept"].items():
            r = ref[f]
            if stats_only:
                vg = abs(float(out[0]) - float(r["stats"][0]))
                a, b = float(out[1]), float(r["stats"][1])
                dg = 0.0 if (math.isnan(a) and math.isnan(b)) else (abs(a - b) / abs(b) if b else abs(a - b))
                gaps["valid_gap"] = max(gaps.get("valid_gap", 0.0), vg)
                gaps["depth_gap"] = max(gaps.get("depth_gap", 0.0), dg if not math.isnan(dg) else 1e30)
            else:
                dm = float(np.mean(out != r["disp"]))
                rp = r["pts"]
                fin = np.isfinite(rp)
                same_nonfinite = np.array_equal(fin, np.isfinite(pts)) and np.array_equal(
                    np.isnan(rp), np.isnan(pts))
                pg = float((np.abs(pts[fin] - rp[fin]) / (np.abs(rp[fin]) + 1.0)).max()) if fin.any() else 0.0
                gaps["disp_mismatch"] = max(gaps.get("disp_mismatch", 0.0), dm)
                gaps["points_gap"] = max(gaps.get("points_gap", 0.0), pg if same_nonfinite else 1e30)
    gaps["missing"] = float(missing)
    return {k: dict(value=v, limit=limits[k]) for k, v in gaps.items()}


def run_cell(root: Path, workload: str, seed: int, seconds: float, traced: bool, device: torch.device,
             t_start: float) -> dict:
    spec = load_cell(root, workload)
    cfg, traffic = spec["config"], spec["traffic"]
    H, W, n = cfg["height"], cfg["width"], cfg["clip_frames"]
    seed = int(seed) & (2**63 - 1)
    tmp = Path(tempfile.mkdtemp(prefix="portbench-"))
    try:
        # --- set-up
        parts = {"imports": time.time() - t_start}
        the_rig = rig.make_rig(seed, H, W, cfg["rig"])
        maps, Q = rig.maps_and_q(the_rig)
        left, right = scene.render_clip(seed, n, H, W, rig.raw_to_rectified(the_rig), device)
        paths = (tmp / "left.avi", tmp / "right.avi")
        for p, frames in zip(paths, (left, right)):
            avi.write_y800(p, frames, cfg["fps"])
        del left, right
        parts["rig, render, write"] = time.time() - t_start - sum(parts.values())
        program = Program(cfg, traffic, device, maps, Q, paths)
        cuda = device.type == "cuda"
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        program.recording()  # warm-up: the first run in a checkout builds the kernels here
        parts["warm-up clip"] = time.time() - t_start - sum(parts.values())
        rng = np.random.default_rng([seed, 11])
        sample = sorted(int(f) for f in rng.choice(n, size=min(traffic["check_frames"], n), replace=False))
        setup_s = time.time() - t_start
        print(f"setup: {parts}", file=sys.stderr)

        # --- the measured window
        recs, waits, frames = [], [], 0
        prof = None
        if traced:
            acts = [torch.profiler.ProfilerActivity.CPU] + ([torch.profiler.ProfilerActivity.CUDA] if cuda else [])
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
        try:
            with torch.profiler.record_function(trace.WINDOW_SPAN):
                t0 = time.perf_counter()
                while not recs or time.perf_counter() - t0 < seconds:
                    r = len(recs)
                    # Stats cells keep every sampled frame; full cells the whole sample in the first
                    # recording, then one sampled frame a recording in turn (15 MB a frame at 720p).
                    if program.stats_only or r == 0:
                        keep = sample.__contains__
                    else:
                        keep = (lambda f, _f=sample[r % len(sample)]: f == _f)
                    rec = program.recording(keep)
                    recs.append(rec)
                    waits += rec["waits"]
                    frames += rec["frames"]
                window_s = time.perf_counter() - t0
        finally:
            if prof is not None:
                prof.__exit__(None, None, None)
        memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0

        run = dict(setup_s=setup_s, window_s=window_s, frames=frames, waits_ms=[w * 1e3 for w in waits],
                   windows=len(waits), recordings=len(recs), trace=None)
        device_info = dict(platform="gpu" if cuda else "cpu",
                           kind=torch.cuda.get_device_name(device) if cuda else "cpu", count=1,
                           memory_peak_bytes=int(memory_peak))
        breakdown = None
        if traced:
            events = trace.events_of(prof)
            del prof
            kernels = port_kernels(spec["dir"])
            tr = trace.analyse(events, {d for k in kernels.values() for d in k["device_kernels"]})
            del events
            tr["bound_s"] = record_bounds(program, kernels) * len(recs)
            run["trace"] = tr
            device_info.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
            breakdown = tr["breakdown"]

        # --- the check, once the program's state is freed
        del program
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        ref_frames = [avi.read_y800(p, sample) for p in paths]
        disp, pts, stats = reference.run(*ref_frames, maps, Q, cfg, device)
        ref = {f: dict(disp=disp[i], pts=pts[i], stats=stats[i]) for i, f in enumerate(sample)}
        checks = compare(recs, ref, bool(traffic["stats_only"]), n, cfg["limits"])
        correct = all(c["value"] <= c["limit"] for c in checks.values())

        metrics = {}
        for m in (spec["per_layer"] if traced else spec["end_to_end"]):
            v = metric_reader(spec["dir"], m["name"])(run)
            if v is not None:
                metrics[m["name"]] = dict(value=v, unit=m["unit"])
        result = dict(correct=correct, attempted=len(recs) * n, failed=int(checks["missing"]["value"]),
                      metrics=metrics, device=device_info)
        if breakdown is not None:
            result["breakdown"] = breakdown
        result["checks"] = checks
        return result
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
