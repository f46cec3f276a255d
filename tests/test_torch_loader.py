"""The port's loader against the JAX package's: ``list_images``, the epoch
streams' index order (also after ``skip``), ``load_image_u8`` with the JAX
native codec out of the path, the loader's batches on the CPU (also from a
resumed ``start_step``), ``make_source`` and the decode-error path. JAX on
the CPU."""

import numpy as np
import pytest
import torch
from PIL import Image

from gan_variant_research_tpu.data import folders as jax_folders
from gan_variant_research_tpu.data import loader as jax_loader
from gan_variant_research_tpu.data import native_loader
from gan_variant_research_tpu_torch.data import folders
from gan_variant_research_tpu_torch.data import loader


@pytest.fixture
def no_native_codec(monkeypatch):
    """The JAX loader decodes JPEGs with its native codec when it builds;
    the port decodes with PIL only (the native codec is not ported)."""
    monkeypatch.setattr(native_loader, "decode_jpeg", lambda path: None)


def _write(folder, names, rng, shape=(40, 36, 3), quality=90):
    folder.mkdir(parents=True, exist_ok=True)
    for name in names:
        img = Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8))
        if name.lower().endswith((".jpg", ".jpeg")):
            img.save(folder / name, quality=quality)
        else:
            img.save(folder / name)


@pytest.fixture
def data_dirs(tmp_path):
    rng = np.random.default_rng(0)
    _write(tmp_path / "photos", [f"p{i:02d}.png" for i in range(9)], rng)
    _write(tmp_path / "monet", [f"m{i:02d}.PNG" for i in range(5)], rng, shape=(30, 50, 3))
    return tmp_path / "photos", tmp_path / "monet"


def test_list_images_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    _write(tmp_path, ["b.JPG", "a.png", "c.jpeg", "d.bmp", "e.webp"], rng, shape=(8, 8, 3))
    (tmp_path / "sub").mkdir()
    _write(tmp_path / "sub", ["x.png"], rng, shape=(8, 8, 3))
    (tmp_path / "notes.txt").write_text("x")
    assert folders.list_images(tmp_path) == jax_folders.list_images(tmp_path)
    assert [p.name for p in folders.list_images(tmp_path)] == ["a.png", "b.JPG", "c.jpeg"]
    with pytest.raises(FileNotFoundError):
        folders.list_images(tmp_path / "missing")


@pytest.mark.parametrize("n, batch, seed, skip", [(9, 2, 42, 0), (9, 2, 42, 7), (5, 5, 43, 3),
                                                  (60, 12, 42, 240), (7, 3, 0, 11)])
def test_epoch_stream_indices_match_jax(n, batch, seed, skip):
    ours = loader._EpochStream(range(n), batch, seed, None)
    theirs = jax_loader._EpochStream(range(n), batch, seed, None)
    ours.skip(skip)
    theirs.skip(skip)
    for _ in range(3 * n // batch + 2):
        assert ours.next_indices() == theirs.next_indices()


def test_epoch_stream_refuses_a_source_smaller_than_the_batch():
    with pytest.raises(ValueError, match="drop_last"):
        loader._EpochStream(range(3), 4, 0, None)


@pytest.mark.parametrize("name, shape, size", [
    ("a.png", (40, 36, 3), 32), ("b.png", (20, 52, 3), 32), ("c.jpg", (37, 29, 3), 32),
    ("d.png", (32, 32, 3), 32), ("e.png", (33, 17, 4), None), ("f.jpeg", (16, 24, 3), 64)])
def test_load_image_u8_matches_jax(tmp_path, no_native_codec, name, shape, size):
    """Bicubic on non-square inputs, RGBA converted, no resize at the size."""
    rng = np.random.default_rng(2)
    img = Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8))
    img.save(tmp_path / name) if name.endswith(".png") else img.convert("RGB").save(
        tmp_path / name, quality=85)
    got = loader.load_image_u8(tmp_path / name, size)
    want = jax_loader.load_image_u8(tmp_path / name, size)
    assert got.dtype == np.uint8 and got.shape[-1] == 3
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("start_step", [0, 5])
def test_loader_batches_match_jax_on_the_cpu(data_dirs, no_native_codec, start_step):
    photos, monet = data_dirs
    ours = loader.UnpairedLoader(photos, monet, batch_size=3, size=32, seed=7, num_workers=2,
                                 prefetch=2, device="cpu", start_step=start_step)
    theirs = jax_loader.UnpairedLoader(photos, monet, batch_size=3, size=32, seed=7,
                                       num_workers=2, prefetch=2, start_step=start_step)
    stream = (loader._EpochStream(range(9), 3, 7, None),
              loader._EpochStream(range(5), 3, 8, None))
    for s in stream:
        s.skip(start_step)
    try:
        assert (ours.num_photos, ours.num_monets) == (9, 5)
        for _ in range(7):
            p, m = next(ours)
            jp, jm = next(theirs)
            assert p.dtype == torch.uint8 and p.device.type == "cpu"
            assert tuple(p.shape) == (3, 32, 32, 3) and tuple(m.shape) == (3, 32, 32, 3)
            np.testing.assert_array_equal(p.numpy(), jp)
            np.testing.assert_array_equal(m.numpy(), jm)
            assert ours.last_indices == tuple(s.next_indices() for s in stream)
    finally:
        ours.close()
        theirs.close()


def test_make_source_passes_a_built_source_and_refuses_tfrecords(tmp_path, data_dirs):
    class Source:
        def __len__(self):
            return 4

        def get(self, idx):
            return np.full((8, 8, 3), idx, np.uint8)

    src = Source()
    assert loader.make_source(src, 8) is src
    assert isinstance(loader.make_source(data_dirs[0], 8), loader.ImageFolderSource)
    (tmp_path / "shard.tfrec").write_bytes(b"")
    with pytest.raises(NotImplementedError, match="Serving, the rest"):
        loader.make_source(tmp_path / "shard.tfrec", 8)
    with pytest.raises(NotImplementedError, match="TFRecord"):
        loader.make_source(tmp_path, 8)
    with pytest.raises(FileNotFoundError):
        loader.make_source(tmp_path / "photos_missing", 8)

    it = loader.UnpairedLoader(src, src, batch_size=2, size=8, seed=1, num_workers=1,
                               device="cpu")
    try:
        p, m = next(it)
        assert sorted(p[:, 0, 0, 0].tolist()) == sorted(it.last_indices[0])
    finally:
        it.close()


def test_a_decode_error_reaches_the_consumer_and_stays(data_dirs):
    photos, monet = data_dirs
    (monet / "zz_broken.png").write_bytes(b"not an image")
    # a batch of every Monet holds the broken file
    it = loader.UnpairedLoader(photos, monet, batch_size=6, size=16, seed=0, num_workers=2,
                               device="cpu")
    try:
        with pytest.raises(OSError):
            next(it)
        with pytest.raises(OSError):
            next(it)
    finally:
        it.close()
