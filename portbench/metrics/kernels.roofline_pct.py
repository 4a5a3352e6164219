"""The port's kernels' bound (bytes over 3.35 TB/s or operations over 67 T/s, ``roofline.py``, from the
arguments of one recorded recording's wrapper calls, times the recordings of the window) over their device
time in the traced window (device trace)."""


def read(run: dict) -> float | None:
    tr = run["trace"]
    if not tr or tr["kernels_s"] <= 0 or tr["bound_s"] <= 0:
        return None
    return 100.0 * tr["bound_s"] / tr["kernels_s"]
