"""The port's eval pipeline end to end against the JAX package's on the
CPU: ``run_evaluation`` of both on the same seeded JPEG folders (10 fake, 8
real, img_size 96) with the same converted ``.npz`` weights (numpy-seeded,
``tests/golden_pool3.py``); the cache's second run; the argparse CLI and
its config chain (the console script: tests/test_torch_packaging.py)."""

import csv
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from gan_variant_research_tpu.evalsuite.inception import save_converted_weights
from gan_variant_research_tpu_torch.evalsuite import cli
from tests.golden_pool3 import deterministic_params



def _folder(folder: Path, n: int, seed: int, size: int = 64) -> Path:
    folder.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    for i in range(n):
        a = rng.uniform(0, 1, (3, 3))
        img = np.stack([a[c, 0] * yy + a[c, 1] * xx + a[c, 2] for c in range(3)], -1)
        img = img / img.max() * 200 + rng.normal(0, 20, (size, size, 3))
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(folder / f"{i:03d}.jpg",
                                                                     quality=95)
    return folder


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval")
    weights = root / "inception_fid.npz"
    save_converted_weights(deterministic_params(seed=0), weights)
    _folder(root / "fake", 10, 0)
    _folder(root / "real", 8, 1)
    return root, weights


def _cfg(root: Path, weights: Path, tag: str, **extra) -> dict:
    return {"name": f"parity_{tag}", "fake_dir": str(root / "fake"),
            "real_dir": str(root / "real"), "real_mode": "folder",
            "out_dir": str(root / tag / "reports"), "cache_dir": str(root / tag / "cache"),
            "batch_size": 4, "num_workers": 2, "img_size": 96, "cosine_eps": 0.1,
            "use_cache": True, "inception_weights": str(weights), **extra}


@pytest.fixture(scope="module")
def reports(setup):
    from gan_variant_research_tpu.evalsuite.cli import run_evaluation as jax_run

    root, weights = setup
    want = jax_run(_cfg(root, weights, "jax", kid=True, pr=True))
    stats = {}
    got = cli.run_evaluation(_cfg(root, weights, "port", kid=True, pr=True), device="cpu",
                             stats=stats)
    return want, got, stats


def _keys(tree, prefix=""):
    out = set()
    for k, v in tree.items():
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= _keys(v, prefix + k + ".")
    return out


def test_scores_match_jax(reports):
    """FID and MiFID within 1e-3 relative (the features agree to ~1e-5 of
    their scale; FID of 8 and 10 samples in 2048 dimensions amplifies
    that), the cosine statistics to 1e-5, KID and precision/recall from
    the same features."""
    want, got, _ = reports
    for k in ("fid", "mifid"):
        assert np.isfinite(got["scores"][k])
        assert abs(got["scores"][k] - want["scores"][k]) <= 1e-3 * abs(want["scores"][k])
    cw, cg = want["scores"]["cosine_min_distance"], got["scores"]["cosine_min_distance"]
    for k in ("median", "mean", "std", "p10", "p90"):
        assert abs(cg[k] - cw[k]) <= 1e-5, k
    assert cg["hist_counts"] == cw["hist_counts"]
    np.testing.assert_allclose(got["scores"]["kid"]["kid_mean"],
                               want["scores"]["kid"]["kid_mean"], rtol=1e-3, atol=1e-6)
    assert got["scores"]["precision_recall"] == want["scores"]["precision_recall"]


def test_reports_have_the_same_keys(reports):
    want, got, _ = reports
    assert _keys(got) == _keys(want)
    assert got["hashes"] == want["hashes"]
    assert got["run"]["warnings"] == want["run"]["warnings"]


def test_worst_case_files_name_the_same_paths(reports, setup):
    root, _ = setup
    want, got, _ = reports
    names = lambda r: [(c["fake_path"], c["nearest_real_path"])  # noqa: E731
                       for c in r["memorization_analysis"]["worst_cases"]]
    assert names(got) == names(want)
    rows = {}
    for tag in ("jax", "port"):
        (path,) = (root / tag / "reports").glob("*_worst_cases.csv")
        with open(path) as f:
            rows[tag] = [(r["rank"], r["fake_path"], r["nearest_real_path"])
                         for r in csv.DictReader(f)]
    assert rows["port"] == rows["jax"] and len(rows["port"]) == 10
    for tag in ("jax", "port"):
        assert list((root / tag / "cache" / "logs").glob("*.txt"))
        (report,) = (root / tag / "reports").glob("*_report.json")
        assert _keys(json.loads(report.read_text())) == _keys(want)


def test_stage_seconds_and_decode_time_are_reported(reports):
    _, _, stats = reports
    assert list(stats["stage_s"]) == ["1_enumerating", "2_validating", "3_hashing",
                                      "4_building", "5_computing", "6_writing"]
    assert all(s >= 0 for s in stats["stage_s"].values())
    assert stats["extractor"]["images"] == 18 and stats["extractor"]["decode_s"] > 0


def test_second_run_hits_the_cache(setup, reports):
    """The real set's stats come from the cache the first run wrote (the
    JAX package's file): the same scores; a cache written by the JAX run
    serves the port too."""
    root, weights = setup
    _, first, _ = reports
    stats = {}
    again = cli.run_evaluation(_cfg(root, weights, "port", kid=True, pr=True), device="cpu",
                               stats=stats)
    assert again["scores"] == first["scores"]
    assert stats["extractor"]["images"] == 10   # the fakes only
    from_jax = cli.run_evaluation(_cfg(root, weights, "jax"), device="cpu", stats=stats)
    assert stats["extractor"]["images"] == 10
    assert from_jax["scores"]["fid"] == first["scores"]["fid"]


def test_main_runs_on_the_cpu_when_asked(setup, monkeypatch):
    root, weights = setup
    out = root / "main"
    report = cli.main(["--fake", str(root / "fake"), "--real", str(root / "real"),
                       "--out", str(out), "--batch", "4", "--workers", "2", "--img-size", "96",
                       "--inception-weights", str(weights), "--no-cache", "--device", "cpu"])
    assert np.isfinite(report["scores"]["fid"]) and list(out.glob("*_report.json"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--fake", str(root / "fake"), "--real", str(root / "real"),
                  "--allow-random-weights"])


def test_config_chain_and_refusals(tmp_path):
    yaml_path = tmp_path / "eval.yaml"
    yaml_path.write_text("name: from_yaml\nfake_dir: a\nreal_dir: b\nbatch_size: 32\n"
                         "cosine_eps: 0.2\nuse_cache: true\n")
    cfg = cli.config_from_args(cli.parse_args(["--config", str(yaml_path), "--batch", "8",
                                               "--no-cache", "--kid"]))
    assert (cfg["name"], cfg["fake_dir"], cfg["batch_size"], cfg["cosine_eps"]) == (
        "from_yaml", "a", 8, 0.2)
    assert cfg["use_cache"] is False and cfg["kid"] is True and cfg["pr"] is False
    assert (cfg["img_size"], cfg["num_workers"], cfg["out_dir"]) == (299, 8, "cache/reports")
    yaml_path.write_text("fake_dir: a\nreal_dir: b\nreal_mode: tfds\n")
    with pytest.raises(ValueError, match="real_mode"):
        cli.config_from_args(cli.parse_args(["--config", str(yaml_path)]))
    with pytest.raises(ValueError, match="--fake and --real"):
        cli.config_from_args(cli.parse_args(["--fake", "a"]))
