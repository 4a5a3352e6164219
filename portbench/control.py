"""The control of the check: the plain reference put in the program's place, in bfloat16.

    python3 portbench/control.py --config <name> --seeds <n> [<n> ...] [--device cuda]

For each seed it makes the run's clip, maps and Q and sample of frames, computes the reference once in
float32 (what a run compares with) and once with every float32 stage in bfloat16 (the nearest precision
below the one the configuration states), and prints, as one JSON line a seed, the numbers a run compares
(both the stats cells' and the full cells'), as ``harness.compare`` reads them. The benchmark's own runs
never run this; a limit lies below what it reads.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import avi, harness, rig, scene  # noqa: E402
from portbench.reference import pipeline as reference  # noqa: E402


def readings(root: Path, config: str, seed: int, check_frames: int, device: torch.device) -> dict:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / next(c for c in bench["configs"] if c["name"] == config)["file"]).read_text())
    H, W, n = cfg["height"], cfg["width"], cfg["clip_frames"]
    seed = int(seed) & (2**63 - 1)
    the_rig = rig.make_rig(seed, H, W, cfg["rig"])
    maps, Q = rig.maps_and_q(the_rig)
    left, right = scene.render_clip(seed, n, H, W, rig.raw_to_rectified(the_rig), device)
    tmp = Path(tempfile.mkdtemp(prefix="portbench-control-"))
    try:
        paths = (tmp / "left.avi", tmp / "right.avi")
        for p, frames in zip(paths, (left, right)):
            avi.write_y800(p, frames, cfg["fps"])
        rng = np.random.default_rng([seed, 11])
        sample = sorted(int(f) for f in rng.choice(n, size=min(check_frames, n), replace=False))
        frames = [avi.read_y800(p, sample) for p in paths]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ref = reference.run(*frames, maps, Q, cfg, device)
    low = reference.run(*frames, maps, Q, cfg, device, fdt=torch.bfloat16)
    ref = {f: dict(disp=ref[0][i], pts=ref[1][i], stats=ref[2][i]) for i, f in enumerate(sample)}
    out = {}
    for stats_only in (True, False):
        kept = {f: ((low[2][i], None) if stats_only else (low[0][i], low[1][i])) for i, f in enumerate(sample)}
        rec = dict(frames=n, seqs=[0], kept=kept)
        checks = harness.compare([rec], ref, stats_only, n, cfg["limits"])
        out.update({k: c["value"] for k, c in checks.items() if k != "missing"})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--check-frames", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", type=Path, default=ROOT)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    for seed in args.seeds:
        r = readings(args.root, args.config, seed, args.check_frames, device)
        print(json.dumps(dict(config=args.config, seed=seed, control="bfloat16", **r)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
