"""Share of the traced window in which no kernel, copy or memset ran on the card (device trace). A trace
with no device activity fails the run before this is read."""


def read(run: dict) -> float | None:
    tr = run["trace"]
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"]) if tr else None
