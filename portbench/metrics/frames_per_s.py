"""Valid frame pairs returned in the measured window over the window's whole time (host clock)."""


def read(run: dict) -> float | None:
    return run["frames"] / run["window_s"] if run["window_s"] > 0 else None
