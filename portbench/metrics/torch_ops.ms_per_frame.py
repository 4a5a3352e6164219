"""Device ms of every kernel and memset that is not the port's own (plain torch: remap, the hier glue,
reprojection, the stats) per frame returned in the traced window (device trace)."""


def read(run: dict) -> float | None:
    tr = run["trace"]
    return 1e3 * tr["torch_ops_s"] / run["frames"] if tr and run["frames"] else None
