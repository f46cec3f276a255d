"""The port's eval metrics, cache and host pipeline against the JAX
package's on the CPU: FID, the memorization penalty, MiFID, KID,
precision/recall and the cosine statistics on seeded features (both sides
float64 numpy: 1e-10 relative); the real-stats cache read across the
packages; the dataset hash; the prefetch thread's error and abandon
paths; the report schema with KID and precision/recall."""

import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image

from gan_variant_research_tpu.evalsuite import features as jax_features
from gan_variant_research_tpu.evalsuite import frechet as jax_frechet
from gan_variant_research_tpu.evalsuite import kid as jax_kid
from gan_variant_research_tpu.evalsuite import mifid as jax_mifid
from gan_variant_research_tpu.evalsuite import prd as jax_prd
from gan_variant_research_tpu.evalsuite import utils as jax_utils
from gan_variant_research_tpu_torch.evalsuite import features, frechet, kid, mifid, prd, utils
from gan_variant_research_tpu_torch.evalsuite.datasets import (
    enumerate_eval_inputs,
    iter_batches,
    load_eval_image,
)
from gan_variant_research_tpu_torch.evalsuite.report import create_report

REL = 1e-10


def _feats(seed, n, d=64, shift=0.0):
    return np.random.default_rng(seed).standard_normal((n, d)) + shift


def _close(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert np.abs(a - b).max(initial=0) <= REL * max(np.abs(b).max(initial=0), 1e-300)


@pytest.mark.parametrize("shift", [0.0, 0.3])
def test_frechet_and_mifid_match_jax(shift):
    real, fake = _feats(0, 200), _feats(1, 150, shift=shift)
    mu_r, sig_r = frechet.gaussian_stats(real)
    mu_f, sig_f = frechet.gaussian_stats(fake)
    for a, b in zip((mu_r, sig_r), jax_frechet.gaussian_stats(real)):
        _close(a, b)
    _close(frechet.frechet_distance(mu_f, sig_f, mu_r, sig_r),
           jax_frechet.frechet_distance(mu_f, sig_f, mu_r, sig_r))
    for eps in (0.1, 10.0):   # the penalty thresholded and not
        _close(frechet.memorization_penalty(fake, real, eps),
               jax_frechet.memorization_penalty(fake, real, eps))
    got, want = frechet.mifid_from_features(real, fake), jax_frechet.mifid_from_features(real, fake)
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k])


def test_frechet_needs_two_rows():
    with pytest.raises(ValueError, match="at least 2"):
        frechet.gaussian_stats(np.zeros((1, 4)))


def test_kid_and_precision_recall_match_jax():
    real, fake = _feats(2, 120), _feats(3, 90, shift=0.2)
    got, want = kid.compute_kid(real, fake, subsets=10, subset_size=50), \
        jax_kid.compute_kid(real, fake, subsets=10, subset_size=50)
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k])
    got, want = prd.compute_precision_recall(real, fake), \
        jax_prd.compute_precision_recall(real, fake)
    assert got == want


def test_cosine_statistics_and_worst_cases_match_jax():
    real, fake = _feats(4, 40), _feats(5, 30)
    d, want_d = (m.compute_cosine_distances_batched(fake, real, batch_size=7)
                 for m in (mifid, jax_mifid))
    _close(d, want_d)
    got, want = (m.compute_cosine_distance_statistics(d) for m in (mifid, jax_mifid))
    assert got.keys() == want.keys()
    for k in want:
        _close(got[k], want[k])
    paths_f, paths_r = [f"f{i}.jpg" for i in range(30)], [f"r{i}.jpg" for i in range(40)]
    assert (mifid.find_worst_memorization_cases(paths_f, d, paths_r, real, fake)
            == jax_mifid.find_worst_memorization_cases(paths_f, d, paths_r, real, fake))


def _jpeg_folder(folder, n, seed, size=40):
    folder.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (size, size, 3), dtype=np.uint8)).save(
            folder / f"{i:03d}.jpg", quality=95)
    (folder / "sub").mkdir()
    Image.fromarray(rng.integers(0, 256, (size, size + 4), dtype=np.uint8)).save(
        folder / "sub" / "gray.png")
    return folder


def test_enumeration_hash_and_validation_match_jax(tmp_path):
    folder = _jpeg_folder(tmp_path / "imgs", 5, 0)
    paths = utils.enumerate_images(folder)
    assert paths == jax_utils.enumerate_images(folder) == enumerate_eval_inputs(folder)
    assert len(paths) == 6
    assert (utils.compute_image_list_hash(paths, folder)
            == jax_utils.compute_image_list_hash(paths, folder))
    got, want = (m.validate_image_counts(paths, paths[:2]) for m in (utils, jax_utils))
    assert got == want and got["warnings"]
    assert utils.check_dataset_overlap(paths, paths[:2]) == jax_utils.check_dataset_overlap(
        paths, paths[:2])


def test_images_decode_as_in_jax(tmp_path):
    """PIL decode and bilinear resize, RGB from a grey PNG: the JAX
    package's pixels (its native JPEG decode is PIL's by its own test)."""
    from gan_variant_research_tpu.evalsuite.datasets import load_eval_image as jax_load

    folder = _jpeg_folder(tmp_path / "imgs", 3, 1)
    for p in utils.enumerate_images(folder):
        got = load_eval_image(p, 48)
        assert got.shape == (48, 48, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, jax_load(p, 48))
    batches = list(iter_batches(utils.enumerate_images(folder), batch_size=3, img_size=48,
                                num_workers=2))
    assert [n for _, n in batches] == [3, 1] and batches[1][0].shape == (3, 48, 48, 3)
    assert not batches[1][0][1:].any()


def test_tfrecord_inputs_are_refused(tmp_path):
    (tmp_path / "monet00.tfrec").write_bytes(b"")
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        enumerate_eval_inputs(tmp_path)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_real_stats_cache_reads_across_packages(tmp_path, writer):
    """The same cache file name for the same (dataset, extractor) key, and
    a cache written by either package read by the other, leaf for leaf."""
    assert (features.cache_path_for(tmp_path, "abc", "random:299")
            == jax_features.cache_path_for(tmp_path, "abc", "random:299"))
    path = features.cache_path_for(tmp_path, "abc", "w.npz:12:299")
    mu, sigma, feats = np.arange(4.0), np.eye(4), _feats(6, 3, 4)
    save, load = ((jax_features.save_cached_stats, features.load_cached_stats)
                  if writer == "jax" else
                  (features.save_cached_stats, jax_features.load_cached_stats))
    save(path, mu, sigma, feats, 3)
    got = load(path)
    assert got["n"] == 3
    for k, v in (("mu", mu), ("sigma", sigma), ("features", feats)):
        np.testing.assert_array_equal(got[k], v)


def test_corrupt_cache_recovers(tmp_path, capsys):
    p = tmp_path / "real_stats" / "k.npz"
    features.save_cached_stats(p, np.zeros(4), np.eye(4), np.zeros((2, 4)), 2)
    assert features.load_cached_stats(p)["n"] == 2
    assert not list(p.parent.glob("*.tmp.npz"))
    p.write_bytes(b"truncated garbage")
    assert features.load_cached_stats(p) is None
    assert "unreadable stats cache" in capsys.readouterr().out


def test_real_stats_are_recomputed_past_a_corrupt_cache(tmp_path):
    class Extractor:
        identity_tag = "random:96"
        calls = 0

        def extract(self, paths, desc="", verbose=True):
            Extractor.calls += 1
            return _feats(7, len(paths), 8)

    paths = [tmp_path / f"{i}.jpg" for i in range(5)]
    path = features.cache_path_for(tmp_path, "h", Extractor.identity_tag)
    path.parent.mkdir(parents=True)
    path.write_bytes(b"garbage")
    first = features.compute_or_load_real_stats(Extractor(), paths, "h", tmp_path)
    again = features.compute_or_load_real_stats(Extractor(), paths, "h", tmp_path)
    assert Extractor.calls == 1 and first["n"] == again["n"] == 5
    np.testing.assert_array_equal(first["features"], again["features"])


def test_prefetch_propagates_producer_errors():
    def bad_batches():
        yield np.zeros((2, 4, 4, 3), np.uint8), 2
        raise OSError("corrupt image")

    it = features._prefetch_to_device(bad_batches())
    batch, n = next(it)
    assert isinstance(batch, torch.Tensor) and n == 2
    with pytest.raises(OSError, match="corrupt image"):
        next(it)


def test_prefetch_thread_exits_when_abandoned():
    def endless():
        while True:
            yield np.zeros((2, 4, 4, 3), np.uint8), 2

    it = features._prefetch_to_device(endless(), depth=1)
    next(it)
    assert any(t.name == "eval-prefetch" and t.is_alive() for t in threading.enumerate())
    it.close()
    deadline = time.time() + 10
    while time.time() < deadline:
        if not any(t.name == "eval-prefetch" and t.is_alive() for t in threading.enumerate()):
            return
        time.sleep(0.05)
    raise AssertionError("eval-prefetch thread still alive after abandon")


def test_prefetch_counts_decode_time():
    stats = {}
    out = list(features._prefetch_to_device(
        ((np.full((1, 2, 2, 3), i, np.uint8), 1) for i in range(3)), stats=stats))
    assert [int(b[0, 0, 0, 0]) for b, _ in out] == [0, 1, 2]
    assert stats["decode_s"] >= 0


@pytest.mark.parametrize("extra, key", [("kid", "kid"), ("precision_recall", "precision_recall")])
def test_kid_and_pr_in_report(extra, key):
    """--kid and --pr add a scores block each; without them the schema is
    unchanged (tests/test_evalsuite.py::test_kid_in_cli_report's case)."""
    base = {"mifid": 1.0, "fid": 2.0, "cosine_min_distance": {}}
    assert key not in create_report(base, {}, {}, {})["scores"]
    block = ({"kid_mean": 0.01, "kid_std": 0.002, "subsets": 100, "subset_size": 50}
             if key == "kid" else {"precision": 0.5, "recall": 0.25, "k": 3})
    report = create_report({**base, extra: block}, {}, {}, {})
    assert report["scores"][key] == block
