"""The port's config module against the JAX package's: ``load_config``
against ``yaml.safe_load`` on every file of ``gan_variant_research_tpu/
configs/`` and against the JAX ``load_config`` on snippets, the port's copy
of the flagship config, ``_coerce``, ``override_config``, ``validate_config``,
``deep_update`` and ``CUT_SCHEMA``."""

import copy
import math
import warnings
from pathlib import Path

import pytest
import yaml

from gan_variant_research_tpu.core import config as jax_config
from gan_variant_research_tpu_torch.core import config as cfg

REPO = Path(__file__).resolve().parents[1]
JAX_CONFIGS = sorted((REPO / "gan_variant_research_tpu" / "configs").glob("*.yaml"))


def _same(a, b) -> bool:
    """Equal, with NaN equal to NaN and bool never equal to int."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return isinstance(b, list) and len(a) == len(b) and all(map(_same, a, b))
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    return type(a) is type(b) and a == b


def test_every_jax_config_is_read():
    assert len(JAX_CONFIGS) == 6


@pytest.mark.parametrize("path", JAX_CONFIGS, ids=lambda p: p.name)
def test_yaml_reader_matches_safe_load_on_the_jax_configs(path):
    assert _same(cfg.load_config(path), yaml.safe_load(path.read_text()))


TEXTS = [
    "a: 1\nb: -2\nc: +3\nd: 0x1F\ne: 017\nf: 0b101\ng: 1_000",
    "a: 2.0e-4\nb: 1e-4\nc: 1.0e5\nd: .5\ne: -.inf\nf: .nan\ng: 1.\nh: -0.0",
    "a: yes\nb: Off\nc: TRUE\nd: ~\ne: null\nf:\ng: on",
    'a: "x # y"\nb: \'it\'\'s\'\nc: "tab\\there \\u00e9"\nd: plain text here  # note',
    "a: [1, 2.5, x, \"q\", [3, 4], {k: v}]\nb: {p: 1, q: [true, null], r: {s: t}}\nc: []\nd: {}",
    "top:\n  mid:\n    low: 1\n  other: 2\nnext: 3",
    "seq:\n- 1\n- two\n- [3]\nindented:\n  - a\n  - b",
    "# comment\n\n---\nkey: value  # trailing\n# another\n",
    "url: http://x.y/z\npath: data/photo_jpg\nweird: a:b",
    "a: &anchor 1", "a: !!str 1", "a: |\n  block", "a: 1:30", "a:\n  - b: 1", "a: [1,\n  2]",
]


def _load(load, path):
    try:
        return load(path)
    except Exception as e:   # noqa: BLE001 - where one side raises, so must the other
        return e


@pytest.mark.parametrize("text", TEXTS)
def test_load_config_matches_jax(text, tmp_path):
    path = tmp_path / "c.yaml"
    path.write_text(text)
    ours, theirs = _load(cfg.load_config, path), _load(jax_config.load_config, path)
    if isinstance(theirs, Exception) or isinstance(ours, Exception):
        # both raise, the same error (each package has its own ConfigError)
        assert type(ours).__name__ == type(theirs).__name__, (ours, theirs)
    else:
        assert _same(ours, theirs)


def test_port_flagship_config_equals_the_jax_file():
    port = REPO / "gan_variant_research_tpu_torch" / "configs" / "train_gan_cutpp.yaml"
    jax_file = REPO / "gan_variant_research_tpu" / "configs" / "train_gan_cutpp.yaml"
    assert _same(cfg.load_config(port), yaml.safe_load(jax_file.read_text()))


def test_load_config_refuses_a_non_mapping_root(tmp_path):
    (tmp_path / "list.yaml").write_text("- 1\n- 2\n")
    (tmp_path / "empty.yaml").write_text("# nothing\n")
    with pytest.raises(cfg.ConfigError, match="mapping"):
        cfg.load_config(tmp_path / "list.yaml")
    assert cfg.load_config(tmp_path / "empty.yaml") == {}


@pytest.mark.parametrize("value", ["true", "FALSE", "None", "null", "12", "-3", "1e-4", "2.5",
                                   "[1,3]", "[a, 2, null]", "[1, [2]]", "[", "hello", "0x10",
                                   "[1, {a: 2}]", ""])
def test_coerce_matches_jax(value):
    assert _same(cfg._coerce(value), jax_config._coerce(value))


def _flagship():
    return cfg.load_config(REPO / "gan_variant_research_tpu" / "configs" / "train_gan_cutpp.yaml")


OVERRIDES = [
    ["loss_weights.adv=0.5", "model.generator.ngf=32"],
    ["model.generator.attn_layers=[1,3]", "new.section.key=yes", "runtime.donate=false"],
    ["no_equals_sign", "max_steps=null", "data.photos_dir=a=b"],
    ["batch_size=8", "image_size=128", "seed=-1"],
]


@pytest.mark.parametrize("overrides", OVERRIDES)
def test_override_config_matches_jax(overrides):
    ours = cfg.override_config(_flagship(), list(overrides))
    theirs = jax_config.override_config(_flagship(), list(overrides))
    assert _same(ours, theirs)


VALIDATE_CASES = [
    ({}, False),
    ({"model": {"generator": {"bogus": 1}}}, False),
    ({"model": {"generator": {"bogus": 1}}}, True),
    ({"batch_size": "12"}, False),
    ({"optim": {"G": {"lr": 1}}}, True),
    ({"model": None}, True),
    ({"model": 3}, False),
    ({"early_stop": {"anything": [1]}}, True),
    ({"runtime": {"steps_per_call": 4, "profile_dir": "x"}}, True),
]


@pytest.mark.parametrize("extra, strict", VALIDATE_CASES)
def test_validate_config_matches_jax(extra, strict):
    def run(module):
        config = module.deep_update(_flagship(), extra)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            try:
                out = ("ok", module.validate_config(config, module.CUT_SCHEMA, strict=strict))
            except ValueError as e:
                out = (type(e).__name__, str(e))
        return out, [str(w.message) for w in caught]

    assert run(cfg) == run(jax_config)


def test_cut_schema_is_the_jax_schema():
    def shape(node):
        if isinstance(node, dict):
            return {k: shape(v) for k, v in node.items()}
        return node

    assert shape(cfg.CUT_SCHEMA) == shape(jax_config.CUT_SCHEMA)


def test_cyclegan_schema_is_the_jax_schema():
    def shape(node):
        if isinstance(node, dict):
            return {k: shape(v) for k, v in node.items()}
        return node

    assert shape(cfg.CYCLEGAN_SCHEMA) == shape(jax_config.CYCLEGAN_SCHEMA)


@pytest.mark.parametrize("name", ["baseline.yaml", "baseline_tpu.yaml"])
def test_port_cyclegan_configs_equal_the_jax_files(name):
    port = REPO / "gan_variant_research_tpu_torch" / "configs" / name
    jax_file = REPO / "gan_variant_research_tpu" / "configs" / name
    assert _same(cfg.load_config(port), yaml.safe_load(jax_file.read_text()))
    assert cfg.validate_config(cfg.load_config(port), cfg.CYCLEGAN_SCHEMA, strict=True) == []


def test_deep_update_matches_jax():
    base = {"a": {"b": 1, "c": [1, 2]}, "d": 2}
    extra = {"a": {"c": [3], "e": {"f": 4}}, "g": None}
    ours = cfg.deep_update(base, extra)
    assert ours == jax_config.deep_update(copy.deepcopy(base), extra)
    assert base == {"a": {"b": 1, "c": [1, 2]}, "d": 2}
