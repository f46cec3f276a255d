"""Reports: the JSON report, the text summary, the worst-cases CSV and the
console summary.

The port's own copy of ``gan_variant_research_tpu/evalsuite/report.py``,
with the same schema (the same keys in the same places), so a report of
either package reads the same."""

from __future__ import annotations

import csv
import json
from datetime import datetime, timezone
from pathlib import Path
from typing import Any


def create_report(
    scores: dict,
    run_config: dict,
    hashes: dict,
    validation: dict,
    worst_cases: list | None = None,
) -> dict[str, Any]:
    report = {
        "run": {
            "name": run_config.get("name", "unnamed_run"),
            "timestamp_utc": datetime.now(timezone.utc).strftime("%Y-%m-%dT%H:%M:%S.%f")
            + "Z",
            "fake_dir": str(run_config.get("fake_dir", "")),
            "real_mode": run_config.get("real_mode", "folder"),
            "real_dir_or_tfds": str(run_config.get("real_dir", "")),
            "num_fake": validation.get("num_fake", 0),
            "num_real": validation.get("num_real", 0),
            "img_size": run_config.get("img_size", 299),
            "batch_size": run_config.get("batch_size", 64),
            "num_workers": run_config.get("num_workers", 8),
            "warnings": validation.get("warnings", []),
        },
        "scores": {
            "mifid": round(float(scores.get("mifid", 0.0)), 4),
            "fid": round(float(scores.get("fid", 0.0)), 4),
            "cosine_min_distance": scores.get("cosine_min_distance", {}),
            # KID and precision/recall are opt-in (--kid, --pr); their keys
            # are present only when computed, so the default schema stays the
            # golden sample_report.json layout
            **({"kid": scores["kid"]} if "kid" in scores else {}),
            **({"precision_recall": scores["precision_recall"]}
               if "precision_recall" in scores else {}),
        },
        "hashes": hashes,
        "notes": (
            "PyTorch MiFID/FID with InceptionV3 pool3 (2048 dims). "
            "uint8 input [0,255] resized to 299x299. "
            "MiFID = FID / M where M is memorization penalty from avg min "
            "cosine distance."
        ),
    }
    if worst_cases:
        report["memorization_analysis"] = {
            "worst_cases": worst_cases,
            "description": (
                "Top-16 fake images with smallest cosine distance to real "
                "set (highest memorization risk)"
            ),
        }
    return report


def save_report(report: dict, output_path: str | Path, verbose: bool = True):
    output_path = Path(output_path)
    output_path.parent.mkdir(parents=True, exist_ok=True)
    with open(output_path, "w") as f:
        json.dump(report, f, indent=2)
    if verbose:
        print(f"\n✓ Report saved to: {output_path}")


def create_text_summary(report: dict) -> str:
    run = report["run"]
    scores = report["scores"]
    cosine = scores.get("cosine_min_distance", {})
    bar = "-" * 70
    lines = ["=" * 70, "KAGGLE MiFID EVALUATION REPORT", "=" * 70]
    lines += [f"Run Name:     {run['name']}", f"Timestamp:    {run['timestamp_utc']}", ""]
    lines += ["DATASETS", bar,
              f"Real mode:    {run['real_mode']}",
              f"Real path:    {run['real_dir_or_tfds']}",
              f"Fake path:    {run['fake_dir']}",
              f"Real images:  {run['num_real']:,}",
              f"Fake images:  {run['num_fake']:,}", ""]
    if run.get("warnings"):
        lines += ["WARNINGS", bar]
        lines += [f"⚠ {w}" for w in run["warnings"]]
        lines += [""]
    lines += ["PRIMARY METRICS", bar,
              f"MiFID:        {scores['mifid']:.4f}  ← KAGGLE LEADERBOARD METRIC",
              f"FID:          {scores['fid']:.4f}", ""]
    lines += ["MEMORIZATION ANALYSIS (Min Cosine Distance)", bar,
              f"Median:       {cosine.get('median', 0):.4f}",
              f"Mean:         {cosine.get('mean', 0):.4f}",
              f"Std:          {cosine.get('std', 0):.4f}",
              f"P10:          {cosine.get('p10', 0):.4f}",
              f"P90:          {cosine.get('p90', 0):.4f}", "",
              "Lower cosine distances = higher memorization risk",
              "MiFID penalizes low distances (i.e., high similarity to real set)",
              ""]
    if "memorization_analysis" in report:
        worst = report["memorization_analysis"]["worst_cases"]
        lines += ["WORST MEMORIZATION CASES (Top-5 shown)", bar]
        for i, case in enumerate(worst[:5], 1):
            lines += [f"{i}. Distance: {case['distance']:.4f}",
                      f"   Fake:  {Path(case['fake_path']).name}",
                      f"   Real:  {Path(case['nearest_real_path']).name}"]
        lines += [""]
    lines += ["CONFIGURATION", bar,
              f"Image size:   {run['img_size']}x{run['img_size']}",
              f"Batch size:   {run['batch_size']}",
              f"Workers:      {run['num_workers']}", ""]
    lines += ["NOTES", bar, report.get("notes", ""), "", "=" * 70]
    return "\n".join(lines)


def save_text_summary(report: dict, output_path: str | Path, verbose: bool = True):
    summary = create_text_summary(report)
    output_path = Path(output_path)
    output_path.parent.mkdir(parents=True, exist_ok=True)
    with open(output_path, "w", encoding="utf-8") as f:
        f.write(summary)
    if verbose:
        print(f"✓ Summary saved to: {output_path}")
        print("\n" + summary)


def save_worst_cases_csv(worst_cases: list, output_path: str | Path):
    output_path = Path(output_path)
    output_path.parent.mkdir(parents=True, exist_ok=True)
    with open(output_path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(
            ["rank", "fake_path", "distance", "cosine_similarity", "nearest_real_path"]
        )
        for i, case in enumerate(worst_cases, 1):
            writer.writerow([
                i,
                case["fake_path"],
                f"{case['distance']:.6f}",
                f"{case['cosine_similarity']:.6f}",
                case["nearest_real_path"],
            ])
    print(f"✓ Worst cases CSV saved to: {output_path}")


def print_quick_summary(scores: dict, validation: dict):
    print("\n" + "=" * 60)
    print("EVALUATION COMPLETE")
    print("=" * 60)
    print(f"Fake images: {validation['num_fake']:,}")
    print(f"Real images: {validation['num_real']:,}")
    print(f"\n{'MiFID:':<20} {scores['mifid']:>10.4f}  ← Kaggle metric")
    print(f"{'FID:':<20} {scores['fid']:>10.4f}")
    cosine = scores.get("cosine_min_distance", {})
    if cosine:
        print("\nCosine Distance (memorization):")
        print(f"  Median: {cosine.get('median', 0):.4f}")
        print(f"  P10:    {cosine.get('p10', 0):.4f}")
        print(f"  P90:    {cosine.get('p90', 0):.4f}")
    print("=" * 60 + "\n")
