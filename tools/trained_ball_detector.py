"""Train the ball detector on the card at the reference's defaults and hold
it to the end-to-end ball bars.

    python3 tools/trained_ball_detector.py [--steps 800]

Runs ``models.pretrained.train_ball_detector`` (YOLOv8n, 128x128, batch 16,
seed 0, AdamW under the warmup-cosine schedule, from flax's initialisation)
into a temporary directory, then the ball-drop chain with the trained
weights: ``synth.scenes.render_ball_drop_stereo`` (80 mm ball, 120 frames a
camera at 240 fps, seed 3) at tests/test_e2e_detectors.py's 320x240 rig
and at 1920x1080 (the same field of view, f = 2100 px, chip_smoke.py's
phase 34), ``detect_balls_in_frames`` and ``track.analyze_ball_drop``
against the test's bars (found in > 90% of frames, gravity within 5% of
9800 mm/s^2), beside the in-repo weights on the same frames. Prints the
card's name and power limit and one JSON line. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from stereo_vision_tpu_torch import track
from stereo_vision_tpu_torch.models import convert, pretrained
from stereo_vision_tpu_torch.synth.scenes import render_ball_drop_stereo

G = 9800.0
RIGS = {"320x240": (350.0, 320, 240), "1920x1080": (2100.0, 1920, 1080)}


def drop_chain(model, f: float, W: int, H: int) -> dict:
    """Found share and gravity of the ball drop rendered at (f, W, H)."""
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1.0]])
    rig = track.StereoRig(K1=K, d1=np.zeros(8), K2=K, d2=np.zeros(8), R=np.eye(3), T=np.array([-500.0, 0, 0]))
    lf, rf, *_ = render_ball_drop_stereo(rig, T=120, fps=240.0, H=H, W=W, hold_frames=25, ball_radius_mm=80.0, seed=3)
    dl = pretrained.detect_balls_in_frames(lf, model=model)
    dr = pretrained.detect_balls_in_frames(rf, model=model)
    found = float(np.mean([d is not None for d in dl + dr]))
    traj = track.analyze_ball_drop(rig, dl, dr, fps=240.0, device=next(model.parameters()).device)
    g = traj.gravity_mm_s2
    err = None if g is None else abs(g - G) / G
    return dict(found=found, gravity_mm_s2=g, gravity_error=err,
                passes=bool(found > 0.9 and err is not None and err < 0.05))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=800)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ball_yolov8n.npz")
        t0 = time.perf_counter()
        res = pretrained.train_ball_detector(steps=args.steps, device=dev, out_path=path)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        trained = convert.load_tree(path, pretrained._ball_model()).to(dev).eval()  # as a user would read it
    in_repo = pretrained.load_ball_detector(dev)
    out = {"card": card, "steps": args.steps, "train_s": train_s, "final_loss": res["final_loss"],
           "loss_first_tenth": float(np.mean(res["losses"][: max(args.steps // 10, 1)])),
           "loss_last_tenth": float(np.mean(res["losses"][-max(args.steps // 10, 1):]))}
    for name, (f, W, H) in RIGS.items():
        out[name] = {"trained": drop_chain(trained, f, W, H), "in_repo": drop_chain(in_repo, f, W, H)}
        print(name, json.dumps(out[name]), flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
