"""The port's FID InceptionV3 (``evalsuite/inception.py``) against the JAX
package's ``InceptionV3FID`` on the CPU: the same numpy-seeded weights
(``tests/golden_pool3.py::deterministic_params``, converted by
``convert.inception_state_dict_from_jax``), the golden pool3 features, the
``.pth`` and ``.npz`` weight paths, and the weight validation. 96 x 96
inputs at batch 2, as tests/test_inception_parity.py runs them: the net is
convolutional up to its global mean, so this is the 299^2 arithmetic at a
tenth of the cost."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_variant_research_tpu.evalsuite.inception import (
    InceptionV3FID as JaxInceptionV3FID,
    preprocess_uint8 as jax_preprocess_uint8,
    save_converted_weights,
)
from gan_variant_research_tpu_torch.convert import inception_state_dict_from_jax
from gan_variant_research_tpu_torch.evalsuite.inception import (
    InceptionFID,
    InceptionV3FID,
    full_float32,
    load_inception_state_dict,
    validate_state_dict,
)
from tests.golden_pool3 import deterministic_params, golden_inputs
from tests.torch_inception_ref import TorchInceptionV3FID, randomize_

GOLDEN = Path(__file__).parent / "golden" / "pool3_features.npz"


@pytest.fixture(scope="module")
def jax_params():
    return deterministic_params(seed=0)


@pytest.fixture(scope="module")
def npz_weights(jax_params, tmp_path_factory):
    path = tmp_path_factory.mktemp("weights") / "inception_fid.npz"
    save_converted_weights(jax_params, path)
    return path


def _port_features(net: InceptionFID, u8: np.ndarray) -> np.ndarray:
    return net.features_u8(u8)


def test_features_match_jax_inception(jax_params, npz_weights):
    """The port's net on the converted weights against the flax net on the
    same params and inputs: float32 both, convolutions summed in another
    order; within 1e-3 of the features' scale, as the JAX parity test
    holds torch's net to the flax one."""
    u8 = np.random.default_rng(0).integers(0, 256, (2, 96, 96, 3), dtype=np.uint8)
    want = np.asarray(JaxInceptionV3FID().apply({"params": jax_params},
                                                jax_preprocess_uint8(jnp.asarray(u8))))
    got = _port_features(InceptionFID(npz_weights, device="cpu"), u8)
    assert got.shape == want.shape == (2, 2048) and got.dtype == np.float32
    scale = float(np.abs(want).max())
    assert scale > 0
    assert float(np.abs(got - want).max()) <= 1e-3 * max(scale, 1.0)


def test_features_match_golden_pool3(npz_weights):
    """The committed pool3 features of the JAX graph, to the golden test's
    own tolerance (2e-4 of the scale, 2e-4 relative)."""
    want = np.load(GOLDEN)["features"]
    got = _port_features(InceptionFID(npz_weights, device="cpu"), golden_inputs(seed=0))
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=2e-4 * max(scale, 1.0), rtol=2e-4)


def test_converter_maps_every_leaf_to_torch_fidelity_names(jax_params):
    sd = inception_state_dict_from_jax(jax_params)
    ref = TorchInceptionV3FID().state_dict()
    assert set(sd) == {k for k in ref if not k.endswith("num_batches_tracked")}
    for k, v in sd.items():
        assert tuple(v.shape) == tuple(ref[k].shape), k
        assert v.dtype == torch.float32
    kernel = jax_params["Mixed_5b"]["branch1x1"]["conv_kernel"]
    np.testing.assert_array_equal(sd["Mixed_5b.branch1x1.conv.weight"].numpy(),
                                  kernel.transpose(3, 2, 0, 1))


def test_converter_is_strict(jax_params):
    bad = {k: v for k, v in jax_params.items()}
    bad["Conv2d_1a_3x3"] = {k: v for k, v in jax_params["Conv2d_1a_3x3"].items()
                            if k != "bn_var"}
    with pytest.raises(ValueError, match="not a BasicConv2d"):
        inception_state_dict_from_jax(bad)
    with pytest.raises(ValueError, match="outside a BasicConv2d"):
        inception_state_dict_from_jax({**jax_params, "stray": np.zeros(3)})


def test_pth_from_the_torch_reference_loads_strictly(tmp_path):
    """A state dict saved from tests/torch_inception_ref.py (torch-fidelity's
    names, BatchNorm counters and all) with a classifier head beside it,
    as the canonical .pth has: the head is skipped, every other leaf loads,
    and the port's features are the reference net's (the same module graph
    on the CPU: 1e-5 of the scale)."""
    ref = randomize_(TorchInceptionV3FID(), seed=0)
    sd = dict(ref.state_dict())
    sd["fc.weight"], sd["fc.bias"] = torch.zeros(1008, 2048), torch.zeros(1008)
    path = tmp_path / "pt_inception.pth"
    torch.save(sd, path)
    net = InceptionFID(path, device="cpu")
    loaded = net.module.state_dict()
    for k, v in ref.state_dict().items():
        assert torch.equal(loaded[k].cpu(), v), k
    u8 = np.random.default_rng(1).integers(0, 256, (2, 96, 96, 3), dtype=np.uint8)
    with torch.no_grad():
        want = ref((torch.from_numpy(u8).permute(0, 3, 1, 2).float() - 128) / 128).numpy()
    got = net.features_u8(u8)
    assert np.abs(got - want).max() <= 1e-5 * max(float(np.abs(want).max()), 1.0)


@pytest.mark.parametrize("breakage", ["missing", "shape", "extra"])
def test_validation_rejects_foreign_weights(jax_params, tmp_path, breakage):
    sd = inception_state_dict_from_jax(jax_params)
    if breakage == "missing":
        del sd["Mixed_7c.branch_pool.bn.running_var"]
    elif breakage == "shape":
        sd["Mixed_6e.branch1x1.conv.weight"] = sd["Mixed_6e.branch1x1.conv.weight"][:100]
    else:
        sd["Mixed_8a.branch1x1.conv.weight"] = torch.zeros(1)
    with pytest.raises(ValueError, match="do not match|wrong leaf shapes"):
        validate_state_dict(InceptionV3FID(), sd)
    path = tmp_path / "bad.pth"
    torch.save(sd, path)
    with pytest.raises(ValueError):
        InceptionFID(path, device="cpu")


def test_random_weights_need_allow_random():
    with pytest.raises(ValueError, match="canonical FID weights"):
        InceptionFID(None, device="cpu")
    net = InceptionFID(None, allow_random=True, device="cpu")
    assert net.randomly_initialized
    feats = net.features_u8(np.zeros((1, 80, 80, 3), np.uint8))
    assert feats.shape == (1, 2048) and np.isfinite(feats).all()


def test_missing_weights_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="pt_inception"):
        load_inception_state_dict(tmp_path / "nope.pth")


def test_small_inputs_are_refused():
    net = InceptionFID(None, allow_random=True, device="cpu")
    with pytest.raises(ValueError, match="75"):
        net.features_u8(np.zeros((1, 74, 80, 3), np.uint8))


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InceptionFID(None, allow_random=True)


def test_tf32_is_off_inside_the_call_only():
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with full_float32():
            assert not torch.backends.cudnn.allow_tf32
            assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
