"""Kernel Inception Distance over the same pool3 features.

The port's own copy of ``gan_variant_research_tpu/evalsuite/kid.py``. KID
(Bińkowski et al., "Demystifying MMD GANs") is an unbiased estimator, the
small-sample companion of FID, over the features already extracted.
torchmetrics / torch-fidelity semantics: polynomial kernel
k(x, y) = (xᵀy / d + 1)³, MMD² averaged over ``subsets`` random subsets of
size ``subset_size`` (without replacement, clamped to the set sizes),
reporting the mean and std across subsets.
"""

from __future__ import annotations

import numpy as np


def _polynomial_kernel(x: np.ndarray, y: np.ndarray,
                       degree: int = 3, gamma: float | None = None,
                       coef: float = 1.0) -> np.ndarray:
    if gamma is None:
        gamma = 1.0 / x.shape[1]
    return (x @ y.T * gamma + coef) ** degree


def _mmd2_unbiased(k_xx: np.ndarray, k_yy: np.ndarray,
                   k_xy: np.ndarray) -> float:
    m = k_xx.shape[0]
    n = k_yy.shape[0]
    sum_xx = (k_xx.sum() - np.trace(k_xx)) / (m * (m - 1))
    sum_yy = (k_yy.sum() - np.trace(k_yy)) / (n * (n - 1))
    sum_xy = k_xy.mean()
    return float(sum_xx + sum_yy - 2.0 * sum_xy)


def compute_kid(real_feats: np.ndarray, fake_feats: np.ndarray,
                subsets: int = 100, subset_size: int = 1000,
                degree: int = 3, gamma: float | None = None,
                coef: float = 1.0, seed: int = 0) -> dict:
    """KID mean/std over random subsets. Features: (N, 2048) float arrays."""
    real = np.asarray(real_feats, dtype=np.float64)
    fake = np.asarray(fake_feats, dtype=np.float64)
    m = min(subset_size, real.shape[0], fake.shape[0])
    if m < 2:
        raise ValueError(f"KID needs ≥2 samples per subset, got {m}")
    # with no room to subsample, every subset is a permutation of the full
    # sets and MMD² is permutation-invariant — one iteration suffices and
    # the reported std is legitimately 0 (no subsampling happened)
    if m == real.shape[0] and m == fake.shape[0]:
        subsets = 1
    rng = np.random.default_rng(seed)
    vals = []
    for _ in range(subsets):
        r = real[rng.choice(real.shape[0], m, replace=False)]
        f = fake[rng.choice(fake.shape[0], m, replace=False)]
        k_rr = _polynomial_kernel(r, r, degree, gamma, coef)
        k_ff = _polynomial_kernel(f, f, degree, gamma, coef)
        k_rf = _polynomial_kernel(r, f, degree, gamma, coef)
        vals.append(_mmd2_unbiased(k_rr, k_ff, k_rf))
    vals = np.asarray(vals)
    return {
        "kid_mean": float(vals.mean()),
        # sample std (ddof=1) per the torchmetrics convention
        "kid_std": float(vals.std(ddof=1)) if len(vals) > 1 else 0.0,
        "subsets": int(subsets),
        "subset_size": int(m),
    }
