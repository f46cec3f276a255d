"""Improved Precision & Recall over the same pool3 features.

The port's own copy of ``gan_variant_research_tpu/evalsuite/prd.py``.
Kynkäänniemi et al., "Improved Precision and Recall Metric for Assessing
Generative Models": precision = fraction of fake samples inside the real
k-NN manifold, recall = fraction of real samples inside the fake manifold,
a set's manifold being the union of hyperspheres around each sample with
radius = distance to its k-th nearest neighbour within the set. Blocked
host numpy over the 2048-d features: no device work.
"""

from __future__ import annotations

import numpy as np


def _pairwise_sq_dists(a: np.ndarray, b: np.ndarray,
                       block: int = 1024) -> np.ndarray:
    """(N, D) × (M, D) → (N, M) squared euclidean distances, row-blocked."""
    b_sq = (b ** 2).sum(axis=1)
    out = np.empty((a.shape[0], b.shape[0]), dtype=np.float64)
    for i in range(0, a.shape[0], block):
        rows = a[i : i + block]
        d = (rows ** 2).sum(axis=1)[:, None] + b_sq[None, :] - 2.0 * rows @ b.T
        out[i : i + block] = np.maximum(d, 0.0)
    return out


def _knn_radii_sq(feats: np.ndarray, k: int, block: int = 1024) -> np.ndarray:
    """Squared distance of each sample to its k-th nearest OTHER sample."""
    n = feats.shape[0]
    radii = np.empty(n, dtype=np.float64)
    sq = (feats ** 2).sum(axis=1)
    for i in range(0, n, block):
        rows = feats[i : i + block]
        d = (rows ** 2).sum(axis=1)[:, None] + sq[None, :] - 2.0 * rows @ feats.T
        d = np.maximum(d, 0.0)
        # exclude self (distance 0 on the diagonal of this block)
        for r, j in enumerate(range(i, min(i + block, n))):
            d[r, j] = np.inf
        radii[i : i + block] = np.partition(d, k - 1, axis=1)[:, k - 1]
    return radii


def _fraction_covered(queries: np.ndarray, support: np.ndarray,
                      support_radii_sq: np.ndarray,
                      block: int = 1024) -> float:
    """Fraction of ``queries`` lying inside ≥1 support hypersphere."""
    s_sq = (support ** 2).sum(axis=1)
    hits = 0
    for i in range(0, queries.shape[0], block):
        rows = queries[i : i + block]
        d = (rows ** 2).sum(axis=1)[:, None] + s_sq[None, :] - 2.0 * rows @ support.T
        hits += int((np.maximum(d, 0.0) <= support_radii_sq[None, :]).any(axis=1).sum())
    return hits / max(1, queries.shape[0])


def compute_precision_recall(real_feats: np.ndarray, fake_feats: np.ndarray,
                             k: int = 3) -> dict:
    """Improved precision/recall with k-NN manifold estimation (k=3 default
    per the paper). Features: (N, 2048) float arrays, N ≥ k+1 each."""
    real = np.asarray(real_feats, dtype=np.float64)
    fake = np.asarray(fake_feats, dtype=np.float64)
    if min(real.shape[0], fake.shape[0]) <= k:
        raise ValueError(
            f"precision/recall needs > k={k} samples per set, got "
            f"{real.shape[0]} real / {fake.shape[0]} fake")
    real_radii = _knn_radii_sq(real, k)
    fake_radii = _knn_radii_sq(fake, k)
    return {
        "precision": _fraction_covered(fake, real, real_radii),
        "recall": _fraction_covered(real, fake, fake_radii),
        "k": int(k),
    }
