"""Device ms of copies between host and device (the stream's staging uploads and read-backs) per frame
returned in the traced window (device trace)."""


def read(run: dict) -> float | None:
    tr = run["trace"]
    return 1e3 * tr["copies_s"] / run["frames"] if tr and run["frames"] else None
