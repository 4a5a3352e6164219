"""Time copies of the BM kernel (csrc/bm.cu) with a phase removed, on one GPU.

Each variant is the source with -D flags that skip a phase; its time beside
the whole kernel's says what the phase costs. Run from the repository root:

    python3 tools/kernel_variants/bm_phases.py [--source PATH]

``--source`` takes another copy of ``bm.cu`` (for example an earlier
commit's, from ``git show <commit>:stereo_vision_tpu_torch/csrc/bm.cu``):
the flags of its kernel (the warp-a-pixel ``bm_kernel`` or the row form
``bm_rows_kernel``) are found by the text they wrap. Variants build in
parallel into ``tools/kernel_variants/_build/``; each is timed at bm1080's
arguments (8 frames of 1920x1080, D=128, block 5) and at bm480's (one
640x480 frame, D=64, block 15), five runs of five launches, and the whole
kernel is held to the plain form on the first frame. Results are printed
and written to ``tools/kernel_variants/_build/bm_phases.json``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
from stereo_vision_tpu_torch import _build  # noqa: E402
from stereo_vision_tpu_torch.stereo import bm  # noqa: E402
from stereo_vision_tpu_torch.synth.scenes import scene  # noqa: E402

OUT = Path(__file__).resolve().parent / "_build"

# (text to find, text to put in its place) for each kernel's flags.
WARP_A_PIXEL = [
    ("  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;\n  __syncthreads();  // the previous step has read V, T and the staged rows",
     "  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;\n#ifdef NO_LEAVE\n  leave = false;\n#endif\n#ifndef ONE_BARRIER\n  __syncthreads();  // the previous step has read V, T and the staged rows\n#endif"),
    ("  __syncthreads();\n  for (int j = warp; j < NC; j += kWarps) {",
     "  __syncthreads();\n#ifndef NO_VUPDATE\n  for (int j = warp; j < NC; j += kWarps) {"),
    ("      V[j * D + d] = v;\n    }\n  }", "      V[j * D + d] = v;\n    }\n  }\n#endif"),
    ("    if (t < bs - 1) continue;  // the window is not full yet (uniform over the block)\n    __syncthreads();\n\n    const int yv = y - bs + 1;\n    int cost[KPL];",
     "    if (t < bs - 1) continue;  // the window is not full yet (uniform over the block)\n#ifndef ONE_BARRIER\n    __syncthreads();\n#endif\n#ifdef NO_OUTPUT\n    continue;\n#endif\n\n    const int yv = y - bs + 1;\n    int cost[KPL];"),
    ("      const int mn = warp_min(m);\n      int bl = kBig;",
     "#ifdef NO_SHUFFLE\n      const int mn = m;\n#else\n      const int mn = warp_min(m);\n#endif\n      int bl = kBig;"),
    ("      const int best = warp_min(bl);\n      const int thresh",
     "#ifdef NO_SHUFFLE\n      const int best = bl;\n#else\n      const int best = warp_min(bl);\n#endif\n      const int thresh"),
    ("      const bool unique_ok = !__any_sync(kFullMask, offend);\n      c0 = warp_sum(c0);\n      cn = warp_sum(cn);\n      cp = warp_sum(cp);",
     "#ifdef NO_SHUFFLE\n      const bool unique_ok = !offend;\n#else\n      const bool unique_ok = !__any_sync(kFullMask, offend);\n      c0 = warp_sum(c0);\n      cn = warp_sum(cn);\n      cp = warp_sum(cp);\n#endif"),
]
WARP_A_PIXEL_VARIANTS = {
    "whole": [], "no_output": ["NO_OUTPUT"], "no_leave": ["NO_LEAVE"], "no_shuffle": ["NO_SHUFFLE"],
    "one_barrier": ["ONE_BARRIER"], "no_vupdate": ["NO_VUPDATE"], "staging_only": ["NO_OUTPUT", "NO_VUPDATE"],
    "no_output_no_leave": ["NO_OUTPUT", "NO_LEAVE"],
}
ROW_FORM = [
    ("    // Row step: thread (j, sp) takes column j", "#ifndef NO_ROWSTEP\n    // Row step: thread (j, sp) takes column j"),
    ("    __syncthreads();\n    if (t < bs - 1) continue;  // the window is not full yet (uniform over the block)\n\n    // Horizontal box",
     "#endif\n    __syncthreads();\n    if (t < bs - 1) continue;  // the window is not full yet (uniform over the block)\n#ifndef NO_HORIZ\n    // Horizontal box"),
    ("    __syncthreads();\n\n    // One thread an output pixel",
     "#endif\n    __syncthreads();\n#ifdef NO_WTA\n    continue;\n#endif\n    // One thread an output pixel"),
]
ROW_FORM_VARIANTS = {
    "whole": [], "no_reduction": ["NO_WTA"], "no_box": ["NO_HORIZ"], "no_row_step": ["NO_ROWSTEP"],
    "no_reduction_no_box": ["NO_WTA", "NO_HORIZ"],
}


def flagged_copy(source: Path) -> tuple[Path, dict]:
    """The source with its kernel's phase flags, beside the build outputs."""
    text = source.read_text()
    edits, variants = (ROW_FORM, ROW_FORM_VARIANTS) if "bm_rows_kernel" in text else (WARP_A_PIXEL,
                                                                                          WARP_A_PIXEL_VARIANTS)
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"{source}: a phase's text is not there; this script knows the warp-a-pixel kernel "
                             "and the row form")
        text = text.replace(old, new)
    text = text.replace('#include "common.cuh"', f'#include "{ROOT / "stereo_vision_tpu_torch/csrc/common.cuh"}"')
    OUT.mkdir(exist_ok=True)
    copy = OUT / "bm_phases.cu"
    copy.write_text(text)
    return copy, variants


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", type=Path, default=ROOT / "stereo_vision_tpu_torch/csrc/bm.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bm_phases: no CUDA device", file=sys.stderr)
        return 1
    copy, variants = flagged_copy(args.source)
    nvcc = _build._nvcc()
    procs = {name: subprocess.Popen([nvcc, *_build._FLAGS, *[f"-D{f}" for f in flags], "-o",
                                     str(OUT / f"bm_{name}.so"), str(copy)], stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
             for name, flags in variants.items()}
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            print(out)
            return 1
        lib = ctypes.CDLL(str(OUT / f"bm_{name}.so"))
        lib.svt_bm_disparity.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [ctypes.c_void_p] * 2
        libs[name] = lib
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda")
    res = {"card": card, "source": str(args.source)}
    for label, (B, H, W, D, bs) in {"bm1080": (8, 1080, 1920, 128, 5), "bm480": (1, 480, 640, 64, 15)}.items():
        frames = [scene(seed=s, H=H, W=W) for s in range(B)]
        lt, rt = (torch.from_numpy(np.stack([f[i] for f in frames])).to(dev) for i in (0, 1))
        lp, rp = bm.prefilter_xsobel(lt, 31).contiguous(), bm.prefilter_xsobel(rt, 31).contiguous()
        out = torch.empty((B, H - bs + 1, W - bs + 1), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        ref = bm.valid_disparity_plain(lp[:1], rp[:1], ndisp=D, mindisp=0, block_size=bs, cap=31, uniq=15,
                                       tex_thr=10)
        for name, lib in libs.items():
            def call():
                return lib.svt_bm_disparity(lp.data_ptr(), rp.data_ptr(), out.data_ptr(), B, H, W, D, 0, bs, 31, 15,
                                            10, None, stream)
            if call() != 0:
                raise SystemExit(f"{name}: launch failed")
            torch.cuda.synchronize()
            exact = bool(torch.equal(out[:1], ref))
            if name == "whole" and not exact:
                raise SystemExit(f"{label}: the whole kernel differs from its plain form")
            runs = []
            for _ in range(5):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(5):
                    call()
                end.record()
                torch.cuda.synchronize()
                runs.append(start.elapsed_time(end) / 5)
            res[f"{label} {name}"] = runs
            print(label, name, "exact" if exact else "(differs: a phase is missing)",
                  [round(r, 4) for r in runs], "median", round(sorted(runs)[2], 4), flush=True)
    (OUT / "bm_phases.json").write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
