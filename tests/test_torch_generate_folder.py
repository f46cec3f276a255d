"""Port's serving path: the flax-free checkpoint reader, the EMA-first
restore, ``stylize_batch`` vs the JAX device step, and ``stylize_folder``'s
output tree and zip."""

import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from gan_variant_research_tpu.models.generator_resnet import ResNetGenerator as JaxGenerator
from gan_variant_research_tpu.ops.color import to_uint8 as jax_to_uint8
from gan_variant_research_tpu.ops.resize import resize_bilinear as jax_resize_bilinear
from gan_variant_research_tpu.train.checkpoint import save_checkpoint
from gan_variant_research_tpu_torch.cli import generate_folder as gf
from gan_variant_research_tpu_torch.convert import generator_state_dict_from_jax
from gan_variant_research_tpu_torch.train.checkpoint import load_checkpoint

CONFIG = {"model": {"generator": {"ngf": 8, "n_blocks": 2}},
          "runtime": {"precision": "fp32"}}


def _params(seed):
    gen = JaxGenerator(ngf=8, n_blocks=2)
    p = gen.init(jax.random.PRNGKey(seed), jnp.zeros((1, 32, 32, 3)))["params"]
    return gen, jax.tree_util.tree_map(np.asarray, p)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    _, raw = _params(0)
    jax_gen, ema = _params(1)
    payload = {"generator": raw, "ema_G": {"decay": 0.999, "shadow": ema},
               "extras": {"bf16": jnp.asarray([1.5, -2.25], jnp.bfloat16),
                          "scalar": np.float32(3.5)}}
    path = save_checkpoint(d / "ckpt_final.msgpack", 7, payload, config=CONFIG,
                           metrics={"fid": 12.5})
    no_ema = save_checkpoint(d / "no_ema.msgpack", 3, {"generator": raw}, config=CONFIG)
    return {"path": path, "no_ema": no_ema, "raw": raw, "ema": ema, "jax_gen": jax_gen}


def _state_equal(gen, params):
    want = generator_state_dict_from_jax(params)
    got = gen.state_dict()
    assert sorted(got) == sorted(want)
    return all(torch.equal(got[k], want[k]) for k in want)


def test_load_checkpoint_reads_flax_msgpack(ckpt):
    blob = load_checkpoint(ckpt["path"])
    assert blob["step"] == 7
    assert blob["config"] == CONFIG and blob["metrics"] == {"fid": 12.5}
    shadow = blob["payload"]["ema_G"]["shadow"]
    np.testing.assert_array_equal(shadow["res_1"]["conv2_kernel"],
                                  ckpt["ema"]["res_1"]["conv2_kernel"])
    assert blob["payload"]["ema_G"]["decay"] == 0.999
    extras = blob["payload"]["extras"]
    np.testing.assert_array_equal(extras["bf16"], np.array([1.5, -2.25], np.float32))
    assert extras["scalar"] == 3.5


def test_load_checkpoint_refuses_chunked_arrays(tmp_path):
    import msgpack

    path = tmp_path / "chunked.msgpack"
    blob = {"step": 1, "config_json": "{}", "metrics_json": "{}",
            "payload": {"w": {"__msgpack_chunked_array__": True, "shape": {}, "chunks": {}}}}
    path.write_bytes(msgpack.packb(blob))
    with pytest.raises(NotImplementedError, match="chunked"):
        load_checkpoint(path)


def test_load_generator_params_is_ema_first(ckpt, capsys):
    gen, config = gf.load_generator_params(ckpt["path"])
    assert config == CONFIG and not gen.training
    assert _state_equal(gen, ckpt["ema"])
    gen, _ = gf.load_generator_params(ckpt["path"], use_ema=False)
    assert _state_equal(gen, ckpt["raw"])
    gen, _ = gf.load_generator_params(ckpt["no_ema"])
    assert _state_equal(gen, ckpt["raw"])
    assert "no EMA shadow" in capsys.readouterr().err


def test_cyclegan_checkpoint_is_not_ported_yet(tmp_path, ckpt):
    path = save_checkpoint(tmp_path / "cg.msgpack", 1,
                           {"G_A2B": ckpt["raw"], "G_B2A": ckpt["raw"]})
    with pytest.raises(NotImplementedError, match="CycleGAN"):
        gf.load_generator_params(path)


@pytest.mark.parametrize("hw", [(32, 32), (48, 40)])
def test_stylize_batch_matches_jax_device_step(ckpt, hw):
    """The JAX closure of generate_folder.py:207-211, rebuilt from its parts,
    vs the port's ``stylize_batch`` on the same uint8 batch (fp32 policy)."""
    size = 32
    u8 = np.random.default_rng(5).integers(0, 256, (2, *hw, 3), dtype=np.uint8)
    x01 = jnp.asarray(u8, jnp.float32) / 255.0
    x = jnp.clip(jax_resize_bilinear(x01, (size, size)), 0.0, 1.0) * 2.0 - 1.0
    y = ckpt["jax_gen"].apply({"params": ckpt["ema"]}, x)
    want = np.asarray(jax_to_uint8(y)).astype(int)
    gen, _ = gf.load_generator_params(ckpt["path"])
    got = gf.stylize_batch(gen, torch.from_numpy(u8), size)
    assert got.dtype == torch.uint8 and got.shape == (2, size, size, 3)
    diff = np.abs(got.numpy().astype(int) - want)
    # identical except 1 level where the float32 value sits at a rounding tie
    assert diff.max() <= 1
    assert (diff == 0).mean() >= 0.99


def _write_tree(root):
    rng = np.random.default_rng(7)
    files = ["a/x.png", "a/x.jpg", "b/y.jpeg", "z.JPG", "c/d/w.bmp"]
    for rel in files:
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray(rng.integers(0, 256, (40, 36, 3), dtype=np.uint8)).save(p)
    (root / "notes.txt").write_text("not an image")
    return files


def test_stylize_folder_mirrors_tree_and_zips(ckpt, tmp_path, capsys):
    photos, out = tmp_path / "photos", tmp_path / "out"
    _write_tree(photos)
    gen, _ = gf.load_generator_params(ckpt["path"])
    zpath = tmp_path / "sub.zip"
    written = gf.stylize_folder(gen, photos, out, size=32, batch=2,
                                zip_path=str(zpath))
    rel = [p.relative_to(out).as_posix() for p in written]
    # sorted input order; x.jpg and x.png both map to x.jpg -> __dup1
    assert rel == ["a/x.jpg", "a/x__dup1.jpg", "b/y.jpg", "c/d/w.jpg", "z.jpg"]
    assert "collision" in capsys.readouterr().out
    for p in written:
        with Image.open(p) as im:
            assert im.size == (32, 32) and im.format == "JPEG"
    with zipfile.ZipFile(zpath) as zf:
        assert sorted(zf.namelist()) == sorted(f"{i}.jpg" for i in range(5))
        assert zf.read("2.jpg") == written[2].read_bytes()


def test_cli_main_limit(ckpt, tmp_path):
    photos, out = tmp_path / "photos", tmp_path / "out"
    _write_tree(photos)
    gf.main(["--ckpt", str(ckpt["path"]), "--photos", str(photos), "--out", str(out),
             "--size", "32", "--batch", "2", "--limit", "3", "--zip", str(tmp_path / "s.zip"),
             "--device", "cpu"])
    assert len(list(out.rglob("*.jpg"))) == 3
    with zipfile.ZipFile(tmp_path / "s.zip") as zf:
        assert sorted(zf.namelist()) == ["0.jpg", "1.jpg", "2.jpg"]
    with pytest.raises(FileNotFoundError):
        gf.stylize_folder(None, tmp_path / "missing", out)


def test_failed_write_stops_the_run_early(ckpt, tmp_path, monkeypatch):
    """An unwritable --out (under a regular file: as root, chmod does not stop
    a write) raises from the first batch's writes once the second batch has
    run, instead of after every batch is decoded and run."""
    photos = tmp_path / "photos"
    _write_tree(photos)                       # 5 images: 5 batches of 1
    blocker = tmp_path / "a_file"
    blocker.write_text("not a directory")
    calls = []
    real = gf.stylize_batch
    monkeypatch.setattr(gf, "stylize_batch", lambda *a: calls.append(1) or real(*a))
    gen, _ = gf.load_generator_params(ckpt["path"])
    with pytest.raises(OSError):
        gf.stylize_folder(gen, photos, blocker / "out", size=32, batch=1)
    assert 0 < len(calls) < 5


def test_main_serves_on_the_card_unless_asked_for_the_cpu(ckpt, tmp_path, monkeypatch):
    """No CUDA device and no ``--device cpu``: it raises, it does not serve
    on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    photos = tmp_path / "photos"
    _write_tree(photos)
    with pytest.raises(RuntimeError, match="--device cpu"):
        gf.main(["--ckpt", str(ckpt["path"]), "--photos", str(photos),
                 "--out", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()
    assert gf.serving_device("cpu") == torch.device("cpu")


VARIANT_CONFIG = {"model": {"generator": {
    "ngf": 8, "n_blocks": 2, "use_attention": True, "attn_layers": [0],
    "use_channel_attn": True, "channel_attn_layers": [1], "use_style_dropout": True}},
    "runtime": {"precision": "fp32"}}


def test_variant_checkpoint_serves_on_the_cpu(tmp_path):
    """A variant checkpoint written as the JAX package writes it (non-zero
    gains) serves with no style draws, as the JAX device step does."""
    gcfg = VARIANT_CONFIG["model"]["generator"]
    jax_gen = JaxGenerator(**{k: tuple(v) if isinstance(v, list) else v
                              for k, v in gcfg.items()})
    p = jax.tree_util.tree_map(np.array, jax_gen.init(jax.random.PRNGKey(2),
                                                      jnp.zeros((1, 32, 32, 3)))["params"])
    rng = np.random.default_rng(3)
    p["attn_0"]["gamma"] = np.float32(0.5)
    p["channel_attn_1"]["fc2"]["kernel"] = rng.standard_normal(
        p["channel_attn_1"]["fc2"]["kernel"].shape).astype(np.float32)
    p["style_gate_0"]["beta"] = rng.uniform(-0.5, 0.5, 32).astype(np.float32)
    path = save_checkpoint(tmp_path / "variant.msgpack", 5,
                           {"generator": p, "ema_G": {"decay": 0.999, "shadow": p}},
                           config=VARIANT_CONFIG)
    gen, _ = gf.load_generator_params(path)
    assert {"attn_0", "channel_attn_1", "style_gate_1"} <= {n for n, _ in gen.named_children()}
    u8 = np.random.default_rng(4).integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    x = jnp.asarray(u8, jnp.float32) / 255.0 * 2.0 - 1.0
    want = np.asarray(jax_to_uint8(jax_gen.apply({"params": p}, x))).astype(int)
    got = gf.stylize_batch(gen, torch.from_numpy(u8), 32).numpy().astype(int)
    diff = np.abs(got - want)
    # identical except 1 level where the float32 value sits at a rounding tie
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.99
