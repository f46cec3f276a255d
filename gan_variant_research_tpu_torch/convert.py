"""JAX ResNet-generator param tree -> the port's ``state_dict``.

Counterpart of ``gan_variant_research_tpu/cli/export_torch_checkpoint.py::
generator_params_to_state_dict``. The port's submodules carry the JAX tree's
names, so the mapping is one to one:

- ``initial_conv``, ``down_i``, ``output_conv``: ``kernel`` HWIO ->
  ``weight`` OIHW, ``bias`` as is;
- ``res_i``: ``conv{1,2}_kernel`` -> ``conv{1,2}_weight`` OIHW,
  ``conv{1,2}_bias`` as is;
- ``up_i``: the flipped HWIO correlation kernel -> PyTorch's
  (in, out, kh, kw) ConvTranspose weight (unflip, then transpose).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def _tensor(a) -> torch.Tensor:
    # a copy: arrays read from msgpack can be read-only views
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _hwio_to_oihw(w) -> torch.Tensor:
    return _tensor(np.asarray(w, np.float32).transpose(3, 2, 0, 1))


def _hwio_to_convtranspose(w) -> torch.Tensor:
    return _tensor(np.asarray(w, np.float32)[::-1, ::-1].transpose(2, 3, 0, 1))


def generator_state_dict_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """Nested dict of arrays (``initial_conv``, ``down_i``,
    ``res_i/conv{1,2}_{kernel,bias}``, ``up_i``, ``output_conv``) -> the
    port's ``ResNetGenerator.state_dict()``. Raises on modules or leaves it
    cannot map (attention / style-gate variants)."""
    sd: dict[str, torch.Tensor] = {}
    consumed: set[str] = set()

    def put(module: str, leaves: dict[str, tuple[str, Callable]]):
        node = dict(params[module])
        for jax_name, (torch_name, fn) in leaves.items():
            if jax_name in node:
                sd[f"{module}.{torch_name}"] = fn(node.pop(jax_name))
        if node:
            raise ValueError(f"{module} has leaves the port cannot map: {sorted(node)}")
        consumed.add(module)

    conv = {"kernel": ("weight", _hwio_to_oihw), "bias": ("bias", _tensor)}
    convt = {"kernel": ("weight", _hwio_to_convtranspose), "bias": ("bias", _tensor)}
    res = {}
    for i in (1, 2):
        res[f"conv{i}_kernel"] = (f"conv{i}_weight", _hwio_to_oihw)
        res[f"conv{i}_bias"] = (f"conv{i}_bias", _tensor)

    n_down = sum(1 for k in params if k.startswith("down_"))
    n_blocks = sum(1 for k in params if k.startswith("res_"))
    if n_down == 0 or n_blocks == 0:
        raise ValueError(
            "Param tree does not look like a ResNetGenerator "
            f"(found {n_down} down convs, {n_blocks} res blocks); "
            f"modules: {sorted(params)[:5]}")
    put("initial_conv", conv)
    for i in range(n_down):
        put(f"down_{i}", conv)
        put(f"up_{i}", convt)
    for i in range(n_blocks):
        put(f"res_{i}", res)
    put("output_conv", conv)

    extra = sorted(set(params) - consumed)
    if extra:
        raise ValueError(
            f"Param tree has modules the port's ResNetGenerator does not have: "
            f"{extra}. Variant checkpoints (use_attention / use_channel_attn / "
            "use_style_dropout) are not ported yet.")
    return sd
