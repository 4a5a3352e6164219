"""Cross-run validation aggregation.

Port of ``stereo_vision_tpu/pipeline/aggregation.py``. It rebuilds the
reference's analyze_validation.py (reference:
stereo_calibration/scripts/archive/analyze_validation.py): collect
per-run distance-validation results (ValidationResult records or the
reference's pickle schema), derive the error-vs-distance table, overall
metrics (:203 ``calculate_overall_metrics`` — count/mean/median/min/max/
std of % and mm errors), plots, and a markdown report with the
reference's recommendation thresholds (<5% excellent, <10% good).
"""

from __future__ import annotations

import json
import logging
import pickle
from pathlib import Path
from typing import Iterable

import numpy as np

from stereo_vision_tpu_torch.track.validators import ValidationResult
from stereo_vision_tpu_torch.utils.filenames import extract_distance_from_filename


def collect_run_results(results_dir: str | Path) -> list[dict]:
    """Load per-run validation records from a directory.

    Accepts both this framework's ``*_validation.json`` artifacts (a
    serialized ValidationResult list) and the reference's
    ``*_validation_results.pkl`` schema (dicts with
    ``measured_distance_mm``/``actual_distance_mm`` keys,
    analyze_validation.py:56-90). When a record lacks the actual
    distance, the filename convention supplies it
    (analyze_validation.py:28).
    """
    out: list[dict] = []
    root = Path(results_dir)
    for p in sorted(root.glob("*_validation.json")):
        for rec in json.loads(p.read_text()):
            rec.setdefault("source", p.name)
            out.append(_normalize(rec, p))
    for p in sorted(root.glob("*_validation_results.pkl")):
        # Per-file guard: one corrupt pickle must not silently drop the
        # remaining runs from the report.
        try:
            with open(p, "rb") as f:
                rec = pickle.load(f)
        except Exception as e:  # noqa: BLE001 - any unpickling failure
            logging.getLogger(__name__).warning("skipping %s: %r", p, e)
            continue
        recs = rec if isinstance(rec, list) else [rec]
        for r in recs:
            if not isinstance(r, dict):
                logging.getLogger(__name__).warning(
                    "skipping non-dict record in %s", p
                )
                continue
            r.setdefault("source", p.name)
            out.append(_normalize(r, p))
    return out


def _normalize(rec: dict, path: Path) -> dict:
    measured = rec.get("measured", rec.get("measured_distance_mm"))
    actual = rec.get("expected", rec.get("actual_distance_mm"))
    if actual in (None, 0):
        actual = extract_distance_from_filename(rec.get("source", path.name))
    r = dict(rec)
    r["measured_distance_mm"] = float(measured) if measured is not None else None
    r["actual_distance_mm"] = float(actual) if actual is not None else None
    if r["measured_distance_mm"] is not None and r["actual_distance_mm"]:
        r["distance_error_mm"] = abs(r["measured_distance_mm"] - r["actual_distance_mm"])
        r["distance_error_percent"] = 100.0 * r["distance_error_mm"] / r["actual_distance_mm"]
    return r


def overall_metrics(results: Iterable[dict]) -> dict | None:
    """count/mean/median/min/max/std of % and mm errors
    (analyze_validation.py:203-230)."""
    valid = [r for r in results if r.get("actual_distance_mm")]
    if not valid:
        return None
    ep = np.array([r.get("distance_error_percent", 0.0) for r in valid])
    em = np.array([r.get("distance_error_mm", 0.0) for r in valid])
    return {
        "count": len(valid),
        "mean_error_percent": float(ep.mean()),
        "median_error_percent": float(np.median(ep)),
        "min_error_percent": float(ep.min()),
        "max_error_percent": float(ep.max()),
        "std_error_percent": float(ep.std()),
        "mean_error_mm": float(em.mean()),
        "median_error_mm": float(np.median(em)),
        "min_error_mm": float(em.min()),
        "max_error_mm": float(em.max()),
        "std_error_mm": float(em.std()),
    }


def error_vs_distance_table(results: Iterable[dict]) -> list[dict]:
    """Rows of (actual, measured, error mm, error %) sorted by distance."""
    rows = [
        {
            "actual_distance_mm": r["actual_distance_mm"],
            "measured_distance_mm": r["measured_distance_mm"],
            "error_mm": r.get("distance_error_mm"),
            "error_percent": r.get("distance_error_percent"),
            "source": r.get("source", "?"),
        }
        for r in results
        if r.get("actual_distance_mm") and r.get("measured_distance_mm") is not None
    ]
    rows.sort(key=lambda r: r["actual_distance_mm"])
    return rows


def save_error_plots(results: list[dict], out_dir: str | Path) -> list[Path]:
    """Actual-vs-measured scatter, error-vs-distance bars, error histogram
    (analyze_validation.py:120-200). Raises ``ImportError`` where
    matplotlib is not installed."""
    from stereo_vision_tpu_torch.pipeline.reporting import pyplot

    plt = pyplot()

    rows = error_vs_distance_table(results)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    if not rows:
        return []
    act = np.array([r["actual_distance_mm"] for r in rows])
    mea = np.array([r["measured_distance_mm"] for r in rows])
    ep = np.array([r["error_percent"] for r in rows])
    paths = []

    fig, ax = plt.subplots(figsize=(7, 5))
    ax.scatter(act, mea, c="tab:blue")
    lim = [0, max(act.max(), mea.max()) * 1.1]
    ax.plot(lim, lim, "k--", alpha=0.5, label="ideal")
    ax.set_xlabel("Actual distance (mm)")
    ax.set_ylabel("Measured distance (mm)")
    ax.set_title("Actual vs. Measured Distance")
    ax.legend()
    p = out / "distance_comparison.png"
    fig.savefig(p, dpi=110)
    plt.close(fig)
    paths.append(p)

    fig, ax = plt.subplots(figsize=(7, 5))
    ax.bar(np.arange(len(ep)), ep, color="tab:orange")
    ax.set_xticks(np.arange(len(ep)))
    ax.set_xticklabels([f"{a:.0f}" for a in act], rotation=45)
    ax.set_xlabel("Actual distance (mm)")
    ax.set_ylabel("Error (%)")
    ax.set_title("Distance Measurement Error")
    p = out / "distance_error.png"
    fig.savefig(p, dpi=110, bbox_inches="tight")
    plt.close(fig)
    paths.append(p)

    fig, ax = plt.subplots(figsize=(7, 5))
    ax.hist(ep, bins=min(10, max(3, len(ep))), color="tab:green", alpha=0.8)
    ax.set_xlabel("Error (%)")
    ax.set_ylabel("Count")
    ax.set_title("Error Distribution")
    p = out / "error_distribution.png"
    fig.savefig(p, dpi=110)
    plt.close(fig)
    paths.append(p)
    return paths


def generate_validation_report(
    results: list[dict], out_dir: str | Path, plots: bool = True
) -> Path:
    """Markdown cross-run report (analyze_validation.py:232-320)."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    metrics = overall_metrics(results)
    rows = error_vs_distance_table(results)
    if plots:
        save_error_plots(results, out)

    lines = ["# Stereo Vision Validation Report", "", "## Summary", ""]
    if metrics:
        lines += [
            f"* **Number of validation tests:** {metrics['count']}",
            f"* **Mean percentage error:** {metrics['mean_error_percent']:.2f}%",
            f"* **Median percentage error:** {metrics['median_error_percent']:.2f}%",
            f"* **Error range:** {metrics['min_error_percent']:.2f}% to "
            f"{metrics['max_error_percent']:.2f}%",
            f"* **Standard deviation of error:** {metrics['std_error_percent']:.2f}%",
            "",
            f"* **Mean absolute error:** {metrics['mean_error_mm']:.2f}mm",
            f"* **Median absolute error:** {metrics['median_error_mm']:.2f}mm",
            "",
        ]
    else:
        lines += ["*No validation tests with known distances found*", ""]

    lines += ["## Detailed Results", "",
              "| Actual (mm) | Measured (mm) | Error (mm) | Error (%) | Source |",
              "|---|---|---|---|---|"]
    for r in rows:
        lines.append(
            f"| {r['actual_distance_mm']:.0f} | {r['measured_distance_mm']:.1f} "
            f"| {r['error_mm']:.1f} | {r['error_percent']:.2f} | {r['source']} |"
        )
    lines.append("")

    lines += ["## Recommendations", ""]
    if metrics:
        m = metrics["mean_error_percent"]
        if m < 5.0:
            lines.append("* The calibration is excellent with an average error below 5%.")
        elif m < 10.0:
            lines.append("* The calibration is good with an average error below 10%.")
        else:
            lines.append(
                "* The average error exceeds 10% — recalibrate with more diverse "
                "checkerboard poses and verify the measured baseline."
            )
    p = out / "validation_report.md"
    p.write_text("\n".join(lines) + "\n")
    (out / "validation_metrics.json").write_text(json.dumps(metrics or {}, indent=2))
    return p


def save_run_results(
    results: Iterable[ValidationResult], out_path: str | Path, source: str | None = None
) -> Path:
    """Serialize a run's ValidationResults to the JSON schema
    collect_run_results reads back."""
    p = Path(out_path)
    p.parent.mkdir(parents=True, exist_ok=True)
    recs = []
    for r in results:
        d = r._asdict()
        if source:
            d["source"] = source
        recs.append(d)
    p.write_text(json.dumps(recs, indent=2))
    return p
