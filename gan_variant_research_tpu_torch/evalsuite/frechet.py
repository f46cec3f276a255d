"""Fréchet distance and MiFID math, in float64 on the host.

The port's own copy of ``gan_variant_research_tpu/evalsuite/frechet.py``.
FID(μ₁,Σ₁,μ₂,Σ₂) = ‖μ₁−μ₂‖² + tr(Σ₁+Σ₂−2·(Σ₁Σ₂)^{1/2}) with the matrix
square root through the symmetric-PSD identity
tr((Σ₁Σ₂)^{1/2}) = tr((√Σ₁ Σ₂ √Σ₁)^{1/2}) = Σᵢ √λᵢ(√Σ₁ Σ₂ √Σ₁): two
eigendecompositions instead of scipy's general sqrtm.

MiFID (torchmetrics MemorizationInformedFrechetInceptionDistance semantics,
the Kaggle metric): d = mean over fakes of min over reals of
(1 − |cos|); m = d if d < eps else 1; MiFID = FID / (m + 1e-15).
"""

from __future__ import annotations

import numpy as np


def gaussian_stats(features: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(N, D) features → (μ, Σ) in float64 (unbiased covariance, like
    torch.cov / np.cov used by torchmetrics)."""
    feats = np.asarray(features, dtype=np.float64)
    if feats.ndim != 2 or feats.shape[0] < 2:
        # np.cov of one row degenerates to a 0-d scalar and the Fréchet
        # matmuls then fail with an opaque gufunc error; torchmetrics'
        # FID imposes the same ≥2-sample minimum with a clear message
        raise ValueError(
            f"FID statistics need at least 2 feature rows, got shape "
            f"{feats.shape} — provide at least 2 images per set"
        )
    mu = feats.mean(axis=0)
    sigma = np.cov(feats, rowvar=False)
    return mu, sigma


def _eigh(mat: np.ndarray):
    """eigh with explicit symmetrization and a scipy fallback (LAPACK's
    default eigensolver can fail to converge on ill-conditioned
    rank-deficient covariances; scipy's 'ev' routine is slower but
    robust)."""
    mat = (mat + mat.T) * 0.5
    try:
        return np.linalg.eigh(mat)
    except np.linalg.LinAlgError:
        from scipy import linalg as sla

        return sla.eigh(mat, driver="ev")


def _sqrtm_psd(mat: np.ndarray) -> np.ndarray:
    """Symmetric-PSD matrix square root via eigh (eigenvalues clipped ≥0)."""
    vals, vecs = _eigh(mat)
    vals = np.clip(vals, 0.0, None)
    return (vecs * np.sqrt(vals)) @ vecs.T


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    mu1 = np.asarray(mu1, np.float64)
    mu2 = np.asarray(mu2, np.float64)
    sigma1 = np.asarray(sigma1, np.float64)
    sigma2 = np.asarray(sigma2, np.float64)

    for name, s in (("sigma1", sigma1), ("sigma2", sigma2)):
        if s.ndim != 2 or s.shape[0] != s.shape[1]:
            # also catches a degenerate 0-d covariance loaded from a stats
            # cache written before the ≥2-sample guard existed
            raise ValueError(
                f"{name} must be a square covariance matrix, got shape "
                f"{s.shape} — were the statistics computed from <2 images?"
            )
    diff = mu1 - mu2
    sqrt_s1 = _sqrtm_psd(sigma1)
    inner = sqrt_s1 @ sigma2 @ sqrt_s1
    vals, _ = _eigh(inner)
    # numerical negatives from near-singular products are clipped; if large
    # negatives appear, regularize like pytorch-fid (add eps·I and retry)
    if vals.min() < -1e-3 * max(1.0, abs(vals.max())):
        offset = np.eye(sigma1.shape[0]) * eps
        sqrt_s1 = _sqrtm_psd(sigma1 + offset)
        inner = sqrt_s1 @ (sigma2 + offset) @ sqrt_s1
        vals, _ = _eigh(inner)
    tr_sqrt = np.sqrt(np.clip(vals, 0.0, None)).sum()
    fid = float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2.0 * tr_sqrt)
    # The Fréchet distance is mathematically ≥ 0; identical (or near-
    # identical) statistics cancel to float noise of either sign, and a
    # noise-negative FID flips MiFID's verdict on an exact-memorization set
    # from maximally-penalized to absurdly good once divided by the tiny
    # penalty (observed: fid −2e-7 → MiFID −1.8e8 on self-comparison).
    return max(fid, 0.0)


def memorization_penalty(
    fake_features: np.ndarray,
    real_features: np.ndarray,
    cosine_eps: float = 0.1,
    batch_size: int = 1000,
) -> float:
    """torchmetrics MiFID memorization distance: mean over fakes of the min
    (1 − |cosine similarity|) to the real set, thresholded at eps."""
    fake = np.asarray(fake_features, np.float64)
    real = np.asarray(real_features, np.float64)
    # torchmetrics drops all-zero rows before normalizing
    fake = fake[np.abs(fake).sum(axis=1) != 0]
    real = real[np.abs(real).sum(axis=1) != 0]
    fake = fake / np.linalg.norm(fake, axis=1, keepdims=True)
    real = real / np.linalg.norm(real, axis=1, keepdims=True)

    mins = np.empty(len(fake))
    for i in range(0, len(fake), batch_size):
        sims = np.abs(fake[i : i + batch_size] @ real.T)
        mins[i : i + batch_size] = (1.0 - sims).min(axis=1)
    # a cosine distance is mathematically ≥ 0: |sims| can exceed 1 by float
    # noise on duplicated rows, and a noise-negative mean would make the
    # m + 1e-15 divisor negative, flipping MiFID's sign
    d = max(float(mins.mean()), 0.0)
    return d if d < cosine_eps else 1.0


def mifid_from_features(
    real_features: np.ndarray,
    fake_features: np.ndarray,
    cosine_eps: float = 0.1,
) -> dict:
    """Full MiFID + FID from raw feature matrices."""
    mu_r, sig_r = gaussian_stats(real_features)
    mu_f, sig_f = gaussian_stats(fake_features)
    fid = frechet_distance(mu_f, sig_f, mu_r, sig_r)
    m = memorization_penalty(fake_features, real_features, cosine_eps)
    return {"fid": fid, "mifid": fid / (m + 1e-15), "memorization_distance": m}
