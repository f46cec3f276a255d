"""MiFID/FID computation and the memorization analysis.

Counterpart of ``gan_variant_research_tpu/evalsuite/mifid.py``: each
feature set is extracted once; scores follow torchmetrics semantics
(frechet.py); the cosine-distance statistics and the worst cases keep the
plain (no-abs) cosine distance convention."""

from __future__ import annotations

from pathlib import Path

import numpy as np

from gan_variant_research_tpu_torch.evalsuite.features import (
    InceptionFeatureExtractor,
)
from gan_variant_research_tpu_torch.evalsuite.frechet import (
    frechet_distance,
    gaussian_stats,
    memorization_penalty,
)


def compute_mifid_and_fid(
    extractor: InceptionFeatureExtractor,
    real_paths: list[Path],
    fake_paths: list[Path],
    cosine_eps: float = 0.1,
    real_stats: dict | None = None,
    verbose: bool = True,
) -> dict:
    """Returns {'mifid', 'fid', 'real_features', 'fake_features'}."""
    if real_stats is None:
        real_feats = extractor.extract(real_paths, "Real images", verbose)
        mu_r, sig_r = gaussian_stats(real_feats)
    else:
        real_feats = real_stats["features"]
        mu_r, sig_r = real_stats["mu"], real_stats["sigma"]

    fake_feats = extractor.extract(fake_paths, "Fake images", verbose)
    mu_f, sig_f = gaussian_stats(fake_feats)

    if verbose:
        print("Computing FID...")
    fid = frechet_distance(mu_f, sig_f, mu_r, sig_r)
    if verbose:
        print("Computing MiFID...")
    m = memorization_penalty(fake_feats, real_feats, cosine_eps)
    return {
        "mifid": fid / (m + 1e-15),
        "fid": fid,
        "memorization_distance": m,
        "real_features": real_feats,
        "fake_features": fake_feats,
    }


def compute_cosine_distances_batched(
    fake_features: np.ndarray,
    real_features: np.ndarray,
    batch_size: int = 1000,
) -> np.ndarray:
    """Min cosine distance (1 − cos, no abs: the analysis convention) of
    each fake to the real set."""
    fake = fake_features / (np.linalg.norm(fake_features, axis=1, keepdims=True) + 1e-8)
    real = real_features / (np.linalg.norm(real_features, axis=1, keepdims=True) + 1e-8)
    mins = np.zeros(len(fake))
    for i in range(0, len(fake), batch_size):
        sims = fake[i : i + batch_size] @ real.T
        mins[i : i + batch_size] = (1.0 - sims).min(axis=1)
    return mins


def compute_cosine_distance_statistics(min_distances: np.ndarray) -> dict:
    """median/mean/std/p10/p90 + 10-bin histogram."""
    hist_counts, hist_bins = np.histogram(min_distances, bins=10)
    return {
        "median": float(np.median(min_distances)),
        "mean": float(np.mean(min_distances)),
        "std": float(np.std(min_distances)),
        "p10": float(np.percentile(min_distances, 10)),
        "p90": float(np.percentile(min_distances, 90)),
        "hist_bins": hist_bins.tolist(),
        "hist_counts": hist_counts.tolist(),
    }


def find_worst_memorization_cases(
    fake_paths: list,
    min_distances: np.ndarray,
    real_paths: list,
    real_features: np.ndarray,
    fake_features: np.ndarray,
    top_k: int = 16,
) -> list[dict]:
    """Top-k fakes closest to a real image + their nearest neighbors."""
    worst_indices = np.argsort(min_distances)[:top_k]
    fake = fake_features / (np.linalg.norm(fake_features, axis=1, keepdims=True) + 1e-8)
    real = real_features / (np.linalg.norm(real_features, axis=1, keepdims=True) + 1e-8)
    cases = []
    for idx in worst_indices:
        sims = fake[idx] @ real.T
        nearest = int(np.argmax(sims))
        d = float(min_distances[idx])
        cases.append({
            "fake_path": str(fake_paths[idx]),
            "distance": d,
            "nearest_real_path": str(real_paths[nearest]),
            "cosine_similarity": float(1.0 - d),
        })
    return cases


def compute_full_evaluation(
    extractor: InceptionFeatureExtractor,
    real_paths: list[Path],
    fake_paths: list[Path],
    cosine_eps: float = 0.1,
    real_stats: dict | None = None,
    verbose: bool = True,
) -> dict:
    """MiFID + FID + cosine statistics + worst cases."""
    scores = compute_mifid_and_fid(
        extractor, real_paths, fake_paths, cosine_eps, real_stats, verbose
    )
    min_d = compute_cosine_distances_batched(
        scores["fake_features"], scores["real_features"]
    )
    return {
        "mifid": scores["mifid"],
        "fid": scores["fid"],
        "memorization_distance": scores["memorization_distance"],
        "cosine_min_distance": compute_cosine_distance_statistics(min_d),
        "worst_memorization_cases": find_worst_memorization_cases(
            fake_paths, min_d, real_paths,
            scores["real_features"], scores["fake_features"],
        ),
        "real_features": scores["real_features"],
        "fake_features": scores["fake_features"],
    }
