"""The port's checkpoint I/O against the JAX package's: its msgpack codec
against ``msgpack`` and ``flax.serialization`` on the same trees (byte for
byte, flax's chunked leaves and a trainer's checkpoint blob included),
checkpoints restored across the two packages leaf for leaf, the tail read of
the stored step, ``keep_last_n``, ``latest_checkpoint``, the async writer,
and the JAX run key of the payload. JAX on the CPU."""

import json

import flax.serialization
import jax
import msgpack
import numpy as np
import pytest
import torch

from gan_variant_research_tpu.train import checkpoint as jax_ckpt
from gan_variant_research_tpu.train.cut_trainer import CUTTrainer as JaxCUTTrainer
from gan_variant_research_tpu_torch.convert import (
    generator_state_dict_from_jax,
    jax_tree_from_state_dict,
)
from gan_variant_research_tpu_torch.core.prng import jax_base_key
from gan_variant_research_tpu_torch.train import checkpoint as ck
from gan_variant_research_tpu_torch.train import msgpack_codec
from gan_variant_research_tpu_torch.train.cut_trainer import CUTTrainer
from test_cut_trainer import tiny_config


def _trees():
    rng = np.random.default_rng(0)
    import ml_dtypes

    return {
        "scalars": {"i": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**63,
                          -1, -32, -33, -128, -129, -32768, -32769, -2**31 - 1, -2**63],
                    "f": 0.999, "neg": -1.5e-300, "t": True, "n": None, "s": "x" * 31,
                    "s32": "y" * 32, "s256": "z" * 256, "s65536": "w" * 65536,
                    "b": b"\x00\xff", "big_bin": b"q" * 70000, "c": 1 - 2j},
        "arrays": {"f32": rng.standard_normal((3, 4)).astype(np.float32),
                   "f64": np.asarray(0.999), "i32": np.asarray(7, np.int32),
                   "u32": np.array([1, 2], np.uint32), "u8": np.arange(200, dtype=np.uint8),
                   "bf16": np.ones((2, 3), ml_dtypes.bfloat16), "empty": np.zeros((0, 5)),
                   "big": rng.standard_normal(20000).astype(np.float32),
                   "np_scalar": np.float32(2.5), "np_int": np.int64(-4)},
        "nested": {"z": {"b": {}, "a": {"y": np.ones(3, np.float32)}},
                   "a": [{"k": 1}, [2, 3], "s"], "m": {str(i): i for i in range(20)}},
    }


def _payload_blob() -> dict:
    """The blob ``save_checkpoint`` packs for a small CUT state on the CPU."""
    cfg = _config("flagship")
    pt = CUTTrainer(cfg)
    return {"step": 4, "payload": ck.to_host(pt.checkpoint_payload(pt.init_state(device="cpu"))),
            "config_json": json.dumps(cfg), "metrics_json": json.dumps({"g_loss": 0.5})}


@pytest.mark.parametrize("name", ["scalars", "arrays", "nested", "payload"])
def test_codec_writes_flax_bytes(name):
    tree = _payload_blob() if name == "payload" else _trees()[name]
    assert msgpack_codec.pack(tree) == flax.serialization.msgpack_serialize(tree)


def _same_tree(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b)
        for k in a:
            _same_tree(a[k], b[k])
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b)
        for x, y in zip(a, b):
            _same_tree(x, y)
    elif isinstance(a, np.ndarray):
        b = np.asarray(b)
        if b.dtype.name == "bfloat16":
            b = b.astype(np.float32)   # the port widens bfloat16 to float32
        assert a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b)
    else:
        assert type(a) is type(b) and a == b


@pytest.mark.parametrize("name", ["scalars", "arrays", "nested"])
def test_codec_reads_what_flax_restores(name):
    data = flax.serialization.msgpack_serialize(_trees()[name])
    _same_tree(msgpack_codec.unpack(data), flax.serialization.msgpack_restore(data))
    # and what msgpack itself decodes, ext types aside
    plain = msgpack.packb({"a": [1, -2, 3.5, None, True, "s", b"b"], "m": {"k": 2**40}})
    assert msgpack_codec.unpack(plain) == msgpack.unpackb(plain)


def test_codec_reassembles_flax_chunked_leaves(monkeypatch):
    """Leaves over the chunk size, made by flax with its chunk size lowered
    (and by the port with the same size: the same bytes)."""
    tree = _trees()["arrays"]
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(msgpack_codec, "MAX_CHUNK_SIZE", 64)
    data = flax.serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in data
    assert msgpack_codec.pack(tree) == data
    got = msgpack_codec.unpack(data)
    _same_tree(got, flax.serialization.msgpack_restore(data))
    np.testing.assert_array_equal(got["big"], tree["big"])


def test_codec_refuses_what_flax_refuses():
    with pytest.raises(TypeError):
        msgpack_codec.pack({"t": (1, 2)})
    with pytest.raises(TypeError):
        msgpack_codec.pack({1: 2})
    with pytest.raises(ValueError, match="incomplete input"):
        msgpack_codec.unpack(msgpack_codec.pack({"a": "bc"})[:-1])


# --------------------------------------------------------------------------- #
# the payload across the two packages

def _config(case: str) -> dict:
    cfg = tiny_config(batch_size=2, parallel={"num_devices": 1}, max_steps=50)
    if case == "cosine":
        cfg["optim"]["G"]["scheduler"] = {"enabled": True, "type": "cosine", "lr_min": 1e-5}
    elif case == "no_clip":
        cfg["grad_clip_g"] = cfg["grad_clip_d"] = 0.0
    elif case == "variant":
        cfg["model"]["generator"].update(
            ngf=8, use_attention=True, attn_layers=[0], use_channel_attn=True,
            channel_attn_layers=[1], use_style_dropout=True)
    return cfg


def _layout(tree):
    if isinstance(tree, dict):
        return {k: _layout(v) for k, v in tree.items()}
    a = np.asarray(tree)
    return a.shape, a.dtype.name


def _randomised(tree, rng):
    """Every array leaf replaced by seeded values of its shape and dtype, but
    EMA's decay (both packages write the config's)."""
    if isinstance(tree, dict):
        return {k: v if k == "decay" else _randomised(v, rng) for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype.kind == "f":
        return rng.standard_normal(a.shape).astype(a.dtype)
    return rng.integers(1, 1000, a.shape).astype(a.dtype)


@pytest.fixture(scope="module")
def jax_payloads():
    out = {}
    for case in ("flagship", "cosine", "no_clip", "variant"):
        jt = JaxCUTTrainer(_config(case))
        out[case] = flax.serialization.to_state_dict(
            jax.tree_util.tree_map(np.asarray, jt.checkpoint_payload(jt.init_state())))
    return out


@pytest.mark.parametrize("case", ["flagship", "cosine", "no_clip", "variant"])
def test_payload_layout_is_the_jax_trainers(jax_payloads, case):
    """The port's payload has the JAX trainer's keys, shapes and dtypes
    (optax's chain(clip, adam) state as flax lays it out), plus
    ``torch_rng``; the run key is the JAX one of the config's seed."""
    pt = CUTTrainer(_config(case))
    payload = ck.to_host(pt.checkpoint_payload(pt.init_state(device="cpu")))
    assert payload.pop("torch_rng").dtype == np.uint8
    assert _layout(payload) == _layout(jax_payloads[case])
    np.testing.assert_array_equal(payload["base_key"], jax_payloads[case]["base_key"])


def _assert_leaves_equal(port_tree, jax_tree, path="payload"):
    if isinstance(jax_tree, dict):
        assert set(port_tree) == set(jax_tree), path
        for k in jax_tree:
            _assert_leaves_equal(port_tree[k], jax_tree[k], f"{path}/{k}")
    else:
        a, b = np.asarray(port_tree), np.asarray(jax_tree)
        assert a.shape == b.shape and np.array_equal(a, b), path


@pytest.mark.parametrize("case", ["flagship", "variant"])
def test_jax_checkpoint_restores_in_the_port(tmp_path, jax_payloads, case):
    payload = _randomised(jax_payloads[case], np.random.default_rng(1))
    path = jax_ckpt.save_checkpoint(tmp_path / "ckpt_step9.msgpack", 9, payload)
    blob = ck.load_checkpoint(path)
    pt = CUTTrainer(_config(case))
    state = pt.state_from_payload(blob["payload"], blob["step"], device="cpu")
    assert state.step == 9
    got = ck.to_host(pt.checkpoint_payload(state))
    got.pop("torch_rng")
    _assert_leaves_equal(got, payload)
    # no torch_rng in a JAX file: the sampler starts from the config's seed
    fresh = torch.Generator().manual_seed(_config(case)["seed"]).get_state()
    assert torch.equal(state.rng.get_state(), fresh)


@pytest.mark.parametrize("case", ["flagship", "variant"])
def test_port_checkpoint_restores_in_jax(tmp_path, jax_payloads, case):
    cfg = _config(case)
    pt = CUTTrainer(cfg)
    values = _randomised(jax_payloads[case], np.random.default_rng(2))
    state = pt.state_from_payload(values, 4, device="cpu")
    path = ck.save_checkpoint(tmp_path / "ckpt_step4.msgpack", 4, pt.checkpoint_payload(state),
                              config=cfg)
    blob = jax_ckpt.load_checkpoint(path)
    assert blob["step"] == 4 and blob["config"] == cfg
    jt = JaxCUTTrainer(cfg)
    jstate = jt.state_from_payload(blob["payload"], blob["step"])
    assert int(jstate.step) == 4
    got = flax.serialization.to_state_dict(
        jax.tree_util.tree_map(np.asarray, jt.checkpoint_payload(jstate)))
    _assert_leaves_equal(got, values)


def test_port_checkpoint_round_trips_the_state_bitwise(tmp_path):
    cfg = _config("flagship")
    pt = CUTTrainer(cfg)
    state = pt.init_state(device="cpu")
    rng = np.random.default_rng(3)
    photos, monets = (torch.from_numpy(rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8))
                      for _ in range(2))
    state, _ = pt.train_step(state, photos, monets)
    path = ck.save_checkpoint(tmp_path / "c.msgpack", state.step, pt.checkpoint_payload(state))
    blob = ck.load_checkpoint(path)
    back = pt.state_from_payload(blob["payload"], blob["step"], device="cpu")
    for part in ("g_params", "d_params", "ema"):
        for name, t in getattr(state, part).items():
            assert torch.equal(getattr(back, part)[name], t.detach()), (part, name)
    for part in ("opt_g", "opt_d"):
        a, b = getattr(state, part), getattr(back, part)
        assert a.count == b.count >= 1   # D steps twice on an R1 step
        assert all(torch.equal(a.mu[n], b.mu[n]) and torch.equal(a.nu[n], b.nu[n])
                   for n in a.mu)
    assert torch.equal(back.rng.get_state(), state.rng.get_state())
    assert back.step == state.step == 1


@pytest.mark.parametrize("seed", [0, 7, 42, 123456789, 2**32 - 1])
def test_jax_base_key_is_the_jax_run_key(seed):
    key = jax.random.split(jax.random.key(jax.numpy.asarray(seed, jax.numpy.uint32)), 3)[2]
    np.testing.assert_array_equal(jax_base_key(seed), np.asarray(jax.random.key_data(key)))


def test_jax_tree_from_state_dict_inverts_the_converter():
    from gan_variant_research_tpu.models import ResNetGenerator as JaxGenerator

    variants = dict(use_attention=True, attn_layers=(0, 2), use_channel_attn=True,
                    channel_attn_layers=(1,), use_style_dropout=True)
    jax_gen = JaxGenerator(ngf=8, n_blocks=3, **variants)
    params = jax.tree_util.tree_map(np.asarray, jax_gen.init(
        jax.random.PRNGKey(0), jax.numpy.zeros((1, 32, 32, 3)))["params"])
    params = _randomised(params, np.random.default_rng(4))
    tree = jax_tree_from_state_dict(generator_state_dict_from_jax(params))
    _assert_leaves_equal(tree, params)


# --------------------------------------------------------------------------- #
# files: the stored step, keep_last_n, latest_checkpoint, the async writer

def test_stored_step_reads_the_tail_of_a_port_file(tmp_path, monkeypatch):
    for step in (0, 7, 127, 128, 65535, 70000, 2**33):
        p = ck.save_checkpoint(tmp_path / f"ckpt_step{step}.msgpack", step,
                               {"g": np.ones((64, 64), np.float32)})
        monkeypatch.setattr(msgpack_codec, "unpack",
                            lambda *_: (_ for _ in ()).throw(AssertionError("full parse")))
        assert ck._stored_step(p) == step
        assert jax_ckpt._stored_step(p) == step
        monkeypatch.undo()


def test_stored_step_falls_back_on_a_foreign_layout(tmp_path):
    blob = msgpack.packb({"step": 41, "zzz": b"x" * 100})
    p = tmp_path / "foreign.msgpack"
    p.write_bytes(blob)
    assert ck._peek_tail_step(blob[-16:]) is None
    assert ck._stored_step(p) == 41


def test_keep_last_n_never_prunes_past_the_file_just_written(tmp_path):
    """A rollback resume re-saves below stale files of a run that went
    further: the file just written survives, the stale ones are left, and
    the files at or below it are pruned to N (as the JAX writer does)."""
    dirs = {}
    for name, save in (("port", ck.save_checkpoint), ("jax", jax_ckpt.save_checkpoint)):
        d = tmp_path / name
        for s in (12, 14, 16, 18, 20):
            save(d / f"ckpt_step{s}.msgpack", s, {"x": np.ones(2)}, keep_last_n=5)
        for s in (2, 4, 6):
            save(d / f"ckpt_step{s}.msgpack", s, {"x": np.ones(2)}, keep_last_n=2)
        dirs[name] = sorted(p.name for p in d.iterdir())
    assert dirs["port"] == dirs["jax"]
    assert "ckpt_step6.msgpack" in dirs["port"] and "ckpt_step2.msgpack" not in dirs["port"]


def test_latest_checkpoint_passes_a_stale_final(tmp_path):
    payload = {"g": np.zeros((2,), np.float32)}
    ck.save_checkpoint(tmp_path / "ckpt_step3.msgpack", 3, payload)
    ck.save_checkpoint(tmp_path / "ckpt_final.msgpack", 5, payload)
    assert ck.latest_checkpoint(tmp_path).name == "ckpt_final.msgpack"
    ck.save_checkpoint(tmp_path / "ckpt_step9.msgpack", 9, payload)
    assert ck.latest_checkpoint(tmp_path).name == "ckpt_step9.msgpack"
    assert jax_ckpt.latest_checkpoint(tmp_path).name == "ckpt_step9.msgpack"
    assert ck.latest_checkpoint(tmp_path / "missing") is None


def test_a_step_right_after_an_async_save_does_not_change_the_file(tmp_path):
    """The port's step updates the state's tensors in place: ``save`` must
    have copied the payload before it returns."""
    cfg = _config("flagship")
    pt = CUTTrainer(cfg)
    state = pt.init_state(device="cpu")
    before = ck.to_host(pt.checkpoint_payload(state))
    rng = np.random.default_rng(5)
    photos, monets = (torch.from_numpy(rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8))
                      for _ in range(2))
    writer = ck.AsyncCheckpointer()
    gate = __import__("threading").Event()
    try:
        # the writer starts only once the step has run
        writer._pool.submit(gate.wait)
        writer.save(tmp_path / "ckpt_step0.msgpack", 0, pt.checkpoint_payload(state))
        state, _ = pt.train_step(state, photos, monets)
        gate.set()
        writer.wait()
    finally:
        gate.set()
        writer.close()
    after = ck.to_host(pt.checkpoint_payload(state))
    assert not np.array_equal(after["generator"]["up_0"]["kernel"],
                              before["generator"]["up_0"]["kernel"])
    written = ck.load_checkpoint(tmp_path / "ckpt_step0.msgpack")["payload"]
    _assert_leaves_equal(written, before)


def test_an_async_save_copies_each_host_leaf_once(tmp_path, monkeypatch):
    """``save`` takes the one copy on the caller's thread; the writer then
    packs that copy as it is."""
    leaf = np.arange(6, dtype=np.float32)
    copies = []
    to_host = ck.to_host

    def counting(tree, copy=True):
        if not isinstance(tree, dict):
            copies.append(copy)
        return to_host(tree, copy)

    monkeypatch.setattr(ck, "to_host", counting)
    w = ck.AsyncCheckpointer()
    try:
        w.save(tmp_path / "c.msgpack", 1, {"x": leaf})
        w.wait()
    finally:
        w.close()
    assert copies == [True, False]
    shared = to_host({"x": leaf}, copy=False)["x"]
    assert shared is leaf and to_host({"x": leaf})["x"] is not leaf
    np.testing.assert_array_equal(ck.load_checkpoint(tmp_path / "c.msgpack")["payload"]["x"],
                                  leaf)


def test_async_errors_are_sticky_and_on_done_follows_the_write(tmp_path):
    seen = []
    w = ck.AsyncCheckpointer()
    w.save(tmp_path / "c.msgpack", 1, {"x": np.ones(2)},
           on_done=lambda p: seen.append((p, p.exists())))
    w.wait()
    assert seen == [(tmp_path / "c.msgpack", True)]
    target = tmp_path / "taken.msgpack"
    target.mkdir()
    w.save(target, 1, {"x": np.ones(2)})
    with pytest.raises(OSError):
        w.wait()
    with pytest.raises(OSError):
        w.save(tmp_path / "ok.msgpack", 2, {"x": np.ones(2)})
    with pytest.raises(OSError):
        w.close()
