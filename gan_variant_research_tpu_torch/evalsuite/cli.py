"""MiFID/FID evaluation CLI of the port, the flags of the JAX package's
``gvr-eval`` (``evalsuite/cli.py``):

    gvr-torch-eval --fake generated_images --real data/monet_jpg \\
        --inception-weights pt_inception-2015-12-05.pth [--config eval.yaml] \\
        [--out DIR] [--batch 64] [--workers 8] [--img-size 299] \\
        [--cosine-eps 0.1] [--no-cache] [--kid] [--pr] [--device cuda]

Six stages: 1 enumerate, 2 validate counts and overlap, 3 dataset hashes,
4 the feature extractor (and the real set's cached statistics), 5 the
metrics, 6 the reports. Flags override the YAML (read by the port's own
``core/config.py::load_config``), which overrides the defaults. Reportable
scores need the canonical FID Inception weights: torch-fidelity's
``pt_inception-2015-12-05`` state dict (.pth) or the JAX package's
converted .npz. Runs on ``--device`` (default ``cuda``, the current CUDA
device); it raises when there is no CUDA device, unless the caller passes
``--device cpu``. Folder inputs only: TFRecord shards wait for ROADMAP
Queue 1 item 5, extraction data-parallel over several cards for item 7.
"""

from __future__ import annotations

import argparse
import time
from datetime import datetime, timezone
from pathlib import Path

from gan_variant_research_tpu_torch.core.config import load_config
from gan_variant_research_tpu_torch.evalsuite.features import (
    InceptionFeatureExtractor,
    compute_or_load_real_stats,
)
from gan_variant_research_tpu_torch.evalsuite.mifid import compute_full_evaluation
from gan_variant_research_tpu_torch.evalsuite.report import (
    create_report,
    print_quick_summary,
    save_report,
    save_text_summary,
    save_worst_cases_csv,
)
from gan_variant_research_tpu_torch.evalsuite.utils import (
    check_dataset_overlap,
    compute_image_list_hash,
    timer,
    validate_image_counts,
)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Compute MiFID/FID for a folder of generated "
                                            "images (PyTorch port)")
    p.add_argument("--config", dest="config_path", default=None, help="YAML config file")
    p.add_argument("--fake", dest="fake_dir", default=None, help="Generated images: a folder")
    p.add_argument("--real", dest="real_dir", default=None, help="Real images: a folder")
    p.add_argument("--out", dest="out_dir", default=None, help="Output dir for reports")
    p.add_argument("--batch", dest="batch_size", type=int, default=None)
    p.add_argument("--workers", dest="num_workers", type=int, default=None)
    p.add_argument("--img-size", dest="img_size", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device to extract features on: cuda (default), cuda:N or cpu")
    p.add_argument("--cosine-eps", dest="cosine_eps", type=float, default=None)
    p.add_argument("--no-cache", dest="no_cache", action="store_true",
                   help="Disable the real-stats cache")
    p.add_argument("--inception-weights", dest="inception_weights", default=None,
                   help="Path to FID InceptionV3 weights (.pth or converted .npz)")
    p.add_argument("--kid", action="store_true",
                   help="Also compute Kernel Inception Distance over the same features")
    p.add_argument("--pr", action="store_true",
                   help="Also compute improved precision/recall over the same features")
    p.add_argument("--allow-random-weights", dest="allow_random_weights",
                   action="store_true", help=argparse.SUPPRESS)
    return p.parse_args(argv)


def config_from_args(args) -> dict:
    """The YAML (if any) with the flags over it and the defaults under it,
    as the JAX CLI chains them; refuses a real_mode other than folder and a
    config without both folders."""
    cfg = load_config(args.config_path) if args.config_path else {}
    cfg["fake_dir"] = args.fake_dir or cfg.get("fake_dir")
    cfg["real_dir"] = args.real_dir or cfg.get("real_dir")
    cfg["out_dir"] = args.out_dir or cfg.get("out_dir", "cache/reports")
    cfg["batch_size"] = args.batch_size or cfg.get("batch_size", 64)
    cfg["num_workers"] = args.num_workers or cfg.get("num_workers", 8)
    cfg["img_size"] = args.img_size or cfg.get("img_size", 299)
    cfg["cosine_eps"] = (args.cosine_eps if args.cosine_eps is not None
                         else cfg.get("cosine_eps", 0.1))
    cfg["use_cache"] = (not args.no_cache) and cfg.get("use_cache", True)
    cfg["cache_dir"] = cfg.get("cache_dir", "cache")
    cfg["inception_weights"] = args.inception_weights or cfg.get("inception_weights")
    cfg["kid"] = args.kid or cfg.get("kid", False)
    cfg["pr"] = args.pr or cfg.get("pr", False)
    cfg.setdefault("name", Path(cfg["fake_dir"] or "run").name)
    cfg.setdefault("real_mode", "folder")
    if cfg.get("real_mode") != "folder":
        raise ValueError("Only real_mode: folder is supported (the reference CLI rejects "
                         "tfds mode as well). TFRecord shards are not read by the port yet "
                         "(ROADMAP Queue 1 item 5).")
    if not cfg["fake_dir"] or not cfg["real_dir"]:
        raise ValueError("--fake and --real (or config) are required")
    return cfg


def _banner(step: int, title: str):
    print("\n" + "=" * 70)
    print(f"STEP {step}: {title}")
    print("=" * 70)


def run_evaluation(cfg: dict, allow_random_weights: bool = False, device="cuda",
                   stats: dict | None = None) -> dict:
    """The six stages on ``device``; returns the report dict. ``stats`` (if
    given) receives each stage's seconds (``stage_s``) and the extractor's
    decode seconds and image count (``extractor``)."""
    from gan_variant_research_tpu_torch.evalsuite.datasets import enumerate_eval_inputs

    stage_s: dict = {}
    clock = [time.perf_counter()]

    def stage(step: int, title: str):
        now = time.perf_counter()
        if stage_s:
            stage_s[list(stage_s)[-1]] = now - clock[0]
        clock[0] = now
        stage_s[f"{step}_{title.split()[0].lower()}"] = 0.0
        _banner(step, title)

    stage(1, "Enumerating images")
    with timer("Enumerate fake images"):
        fake_paths = enumerate_eval_inputs(cfg["fake_dir"])
    with timer("Enumerate real images"):
        real_paths = enumerate_eval_inputs(cfg["real_dir"])
    print(f"Found {len(fake_paths)} fake, {len(real_paths)} real images")

    stage(2, "Validating datasets")
    validation = validate_image_counts(fake_paths, real_paths)
    for w in validation["warnings"]:
        print(f"⚠ {w}")
    overlap = check_dataset_overlap(fake_paths, real_paths)
    if overlap["has_overlap"]:
        print(f"⚠ Filename overlap between sets: {overlap['overlap_count']} "
              f"files, e.g. {overlap['overlap_examples'][:3]}")
        validation["warnings"].append(
            f"Filename overlap between fake and real sets ({overlap['overlap_count']} files)")

    stage(3, "Hashing datasets")
    with timer("Hash image lists"):
        fake_hash = compute_image_list_hash(fake_paths, Path(cfg["fake_dir"]))
        real_hash = compute_image_list_hash(real_paths, Path(cfg["real_dir"]))
    hashes = {"fake_list_sha1": fake_hash, "real_list_sha1": real_hash,
              "real_cache_key": f"{Path(cfg['real_dir']).name}@sha1:{real_hash[:16]}"}
    print(f"Fake SHA1: {fake_hash}")
    print(f"Real SHA1: {real_hash}")

    stage(4, "Building feature extractor")
    extractor = InceptionFeatureExtractor(
        weights_path=cfg.get("inception_weights"), allow_random=allow_random_weights,
        batch_size=cfg["batch_size"], img_size=cfg["img_size"],
        num_workers=cfg["num_workers"], device=device)
    print(f"Feature extraction on {extractor.net.device}")
    if extractor.net.randomly_initialized:
        validation["warnings"].append(
            "RANDOM Inception weights — scores are NOT comparable to Kaggle")
    real_stats = None
    if cfg["use_cache"]:
        real_stats = compute_or_load_real_stats(extractor, real_paths, real_hash,
                                                cfg["cache_dir"], use_cache=True)

    stage(5, "Computing metrics")
    with timer("MiFID/FID computation"):
        results = compute_full_evaluation(extractor, real_paths, fake_paths,
                                          cosine_eps=cfg["cosine_eps"], real_stats=real_stats)
    if cfg.get("kid"):
        from gan_variant_research_tpu_torch.evalsuite.kid import compute_kid

        with timer("KID computation"):
            results["kid"] = compute_kid(results["real_features"], results["fake_features"])
    if cfg.get("pr"):
        from gan_variant_research_tpu_torch.evalsuite.prd import compute_precision_recall

        with timer("Precision/recall computation"):
            results["precision_recall"] = compute_precision_recall(
                results["real_features"], results["fake_features"])

    stage(6, "Writing reports")
    report = create_report(scores=results, run_config=cfg, hashes=hashes,
                           validation=validation,
                           worst_cases=results["worst_memorization_cases"])
    out_dir = Path(cfg["out_dir"])
    stamp = datetime.now(timezone.utc).strftime("%Y%m%d_%H%M%S")
    save_report(report, out_dir / f"{stamp}_{cfg['name']}_report.json")
    save_text_summary(report, Path(cfg["cache_dir"]) / "logs" / f"{stamp}_{cfg['name']}.txt")
    save_worst_cases_csv(results["worst_memorization_cases"],
                         out_dir / f"{stamp}_{cfg['name']}_worst_cases.csv")
    print_quick_summary(report["scores"], validation)
    stage_s[list(stage_s)[-1]] = time.perf_counter() - clock[0]
    if stats is not None:
        stats["stage_s"] = stage_s
        stats["extractor"] = dict(extractor.stats)
    return report


def main(argv=None) -> dict:
    """Compute MiFID/FID for a folder of generated images."""
    from gan_variant_research_tpu_torch.evalsuite.inception import eval_device

    args = parse_args(argv)
    device = eval_device(args.device)
    return run_evaluation(config_from_args(args), allow_random_weights=args.allow_random_weights,
                          device=device)


if __name__ == "__main__":
    main()
