"""Seconds from the process's start to the first measured window: imports, the rig, rendering and
writing the clips, the warm-up clip (and in a fresh checkout the kernels' build) (host clock)."""


def read(run: dict) -> float | None:
    return run["setup_s"]
