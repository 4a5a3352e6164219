"""Device ms of the port's own CUDA kernels (the ``kernels/*.json`` files' names) per frame returned in
the traced window (device trace)."""


def read(run: dict) -> float | None:
    tr = run["trace"]
    return 1e3 * tr["kernels_s"] / run["frames"] if tr and tr["kernels_s"] > 0 and run["frames"] else None
