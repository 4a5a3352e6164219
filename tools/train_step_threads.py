"""Host ms a float32 train() step of the data-parallel training step
(``models.train.make_train_step`` given the model) on two logical shards of
one GPU, three ways of running the shares' threads, in turns:

- ``turns``: the step as it is, its pool's threads kept from step to step
  and taking turns between the batch-statistics meetings;
- ``fresh``: the same with a new pool every step (new threads each step);
- ``barrier``: the kept threads running at once and meeting at a
  ``threading.Barrier`` (``BarrierMeeting`` below);

and beside them the 1x1 step. The cases are ``chip_smoke.py``'s phase-36
train() mode cases (``mesh_bn_cases``): PoseNet w32 (in-repo weights) at
128x128, batch 8 and at 256x256, batch 16, YOLOv8n (in-repo weights) at
128x128, batch 16; SGD at lr 0, cuDNN's deterministic algorithms. Each form
runs STEPS steps; the median of the steps after the first two is reported,
with the share threads' part (the forward pass) apart. Every form's losses
must equal the ``turns`` form's within rtol 1e-6.

Run from the repository root:

    python3 tools/train_step_threads.py

One JSON line a case and form, after the card's name and power limit.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import statistics
import subprocess
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from stereo_vision_tpu_torch.models import train  # noqa: E402
from stereo_vision_tpu_torch.parallel.mesh import create_mesh, to_device  # noqa: E402

STEPS = 8
FORMS = ("1x1", "turns", "barrier", "fresh", "fresh", "barrier", "turns", "1x1")


class BarrierMeeting(train._Meeting):
    """The shares' threads at once, meeting at a barrier whose action (the
    last thread to arrive) forms the whole batch's statistics."""

    def __init__(self, n: int, first: torch.device):
        super().__init__(n, first)
        self.barrier = threading.Barrier(n, action=self._reduce)

    def wait_turn(self, share: int) -> None:
        pass

    def hand_on(self, share: int) -> None:
        pass

    def abort(self) -> None:
        self.barrier.abort()

    def meet(self, share: int, x: torch.Tensor | None):
        if x is None:
            self.posts[share] = None
        else:
            dims = [d for d in range(x.ndim) if d != 1]
            xf = x.to(torch.promote_types(x.dtype, torch.float32))
            self.posts[share] = (xf.sum(dims), (xf * xf).sum(dims), x.numel() // x.shape[1])
        self.barrier.wait()
        total = self.total  # read before this share can post again (the next action needs its post)
        return None if total is None else tuple(to_device(t, x.device) for t in total)


def run_form(form: str, dev: torch.device, net, x, gt, loss_fn) -> dict:
    """STEPS steps of one form: host ms a step, ms in the share threads, the losses."""
    each, meeting = train._each_share, train._Meeting
    forward_ms: list = []

    def timed(pool, n, first, run):
        t0 = time.perf_counter()
        try:
            if form == "fresh":
                with concurrent.futures.ThreadPoolExecutor(n) as fresh:
                    return each(fresh, n, first, run)
            return each(pool, n, first, run)
        finally:
            forward_ms.append((time.perf_counter() - t0) * 1e3)

    train._each_share = timed
    train._Meeting = BarrierMeeting if form == "barrier" else meeting
    try:
        n_data = 1 if form == "1x1" else 2
        init, step = train.make_train_step(create_mesh(n_data, 1, devices=[dev] * n_data), net, loss_fn,
                                           lambda p: torch.optim.SGD(p, lr=0.0))
        state = init({"params": dict(net.named_parameters()), "batch_stats": dict(net.named_buffers())})
        xs, ts = torch.as_tensor(x), torch.as_tensor(gt)
        ms, losses = [], []
        for _ in range(STEPS):
            t0 = time.perf_counter()
            state, loss = step(state, xs, ts)
            losses.append(loss.item())
            ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        train._each_share, train._Meeting = each, meeting
    return dict(median_ms=statistics.median(ms[2:]), ms=ms, losses=losses,
                forward_median_ms=statistics.median(forward_ms[2:]) if forward_ms else None)


def main() -> int:
    if not torch.cuda.is_available():
        print("train_step_threads: no CUDA device is available", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    cases = chip_smoke.mesh_bn_cases(dev)
    del cases["Linear-BatchNorm1d-Linear"]
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True, allow_tf32=False):
        for name, (net, x, gt, loss_fn) in cases.items():
            runs = [(form, run_form(form, dev, net, x, gt, loss_fn)) for form in FORMS]
            ref = next(r["losses"] for form, r in runs if form == "turns")
            for form, r in runs:
                apart = max(abs(a - b) / abs(b) for a, b in zip(r["losses"], ref))
                if form != "1x1" and apart > 1e-6:
                    raise AssertionError(f"{name}: the {form} form's losses {r['losses']} against {ref}")
                print(json.dumps({"case": name, "form": form, "median_ms": r["median_ms"],
                                  "forward_median_ms": r["forward_median_ms"], "ms": r["ms"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
