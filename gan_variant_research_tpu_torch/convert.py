"""JAX generator and discriminator param trees -> the port's ``state_dict``s.

Counterpart of ``gan_variant_research_tpu/cli/export_torch_checkpoint.py::
generator_params_to_state_dict``. The port's submodules carry the JAX tree's
names, so the mapping is one to one:

- ``initial_conv``, ``down_i``, ``output_conv``: ``kernel`` HWIO ->
  ``weight`` OIHW, ``bias`` as is;
- ``res_i``: ``conv{1,2}_kernel`` -> ``conv{1,2}_weight`` OIHW,
  ``conv{1,2}_bias`` as is;
- ``up_i``: the flipped HWIO correlation kernel -> PyTorch's
  (in, out, kh, kw) ConvTranspose weight (unflip, then transpose);
- the variant blocks: ``attn_i/{query,key,value,out}`` (1x1 HWIO ->
  OIHW, bias as is) and the scalar ``attn_i/gamma``;
  ``channel_attn_i/fc{1,2}`` (Dense ``kernel`` (in, out) -> ``weight``
  (out, in), bias as is); ``style_gate_i/{gamma,beta}`` as they are.

``jax_tree_from_state_dict`` is the inverse, for the checkpoint writer.
``inception_state_dict_from_jax`` maps the JAX package's FID InceptionV3
tree to torch-fidelity's names (the evaluator's ``.npz`` weights).
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


def _dense_to_linear(w) -> torch.Tensor:
    return _tensor(np.asarray(w, np.float32).T)


def generator_state_dict_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """Nested dict of arrays (``initial_conv``, ``down_i``,
    ``res_i/conv{1,2}_{kernel,bias}``, ``up_i``, ``output_conv`` and the
    variant blocks ``attn_i``, ``channel_attn_i``, ``style_gate_i``) -> the
    port's ``ResNetGenerator.state_dict()``. Raises on modules or leaves it
    cannot map, and on a variant block that lacks one."""
    sd: dict[str, torch.Tensor] = {}
    consumed: set[str] = set()

    def take(prefix: str, node: dict, leaves: dict[str, tuple[str, Callable]],
             required: bool = False):
        node = dict(node)
        for jax_name, (torch_name, fn) in leaves.items():
            if jax_name in node:
                sd[f"{prefix}.{torch_name}"] = fn(node.pop(jax_name))
            elif required:
                raise ValueError(f"{prefix} lacks its leaf {jax_name!r}")
        if node:
            raise ValueError(f"{prefix} has leaves the port cannot map: {sorted(node)}")

    def put(module: str, leaves: dict[str, tuple[str, Callable]],
            children: dict[str, dict] | None = None):
        node = dict(params[module])
        for child, child_leaves in (children or {}).items():
            if child not in node:
                raise ValueError(f"{module} lacks its submodule {child!r}")
            take(f"{module}.{child}", node.pop(child), child_leaves, required=True)
        take(module, node, leaves, required=children is not None)
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
    dense = {"kernel": ("weight", _dense_to_linear), "bias": ("bias", _tensor)}
    variants = {
        "attn": ({"gamma": ("gamma", _tensor)},
                 {name: conv for name in ("query", "key", "value", "out")}),
        "channel_attn": ({}, {"fc1": dense, "fc2": dense}),
        "style_gate": ({"gamma": ("gamma", _tensor), "beta": ("beta", _tensor)}, {}),
    }
    for i in range(n_blocks):
        put(f"res_{i}", res)
        for kind, (leaves, children) in variants.items():
            if f"{kind}_{i}" in params:
                put(f"{kind}_{i}", leaves, children)
    put("output_conv", conv)

    extra = sorted(set(params) - consumed)
    if extra:
        raise ValueError(
            f"Param tree has modules the port's ResNetGenerator does not have: {extra}")
    return sd


def discriminator_state_dict_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """JAX ``MultiscaleDiscriminator`` param tree (``scale_i/conv_n``,
    ``scale_i/conv_out``, each ``kernel`` HWIO and ``bias``) -> the port's
    ``MultiscaleDiscriminator.state_dict()``. Raises on modules or leaves it
    cannot map (spectral-norm state lives outside ``params`` and is not
    ported)."""
    sd: dict[str, torch.Tensor] = {}
    leaves = {"kernel": ("weight", _hwio_to_oihw), "bias": ("bias", _tensor)}
    scales = sorted(k for k in params if k.startswith("scale_"))
    if not scales or set(params) != set(scales):
        raise ValueError("Param tree does not look like a MultiscaleDiscriminator: "
                         f"modules {sorted(params)[:5]}")
    for scale in scales:
        for conv, node in params[scale].items():
            if not (conv == "conv_out" or conv.startswith("conv_")):
                raise ValueError(f"{scale} has a module the port cannot map: {conv}")
            node = dict(node)
            for jax_name, (torch_name, fn) in leaves.items():
                if jax_name in node:
                    sd[f"{scale}.{conv}.{torch_name}"] = fn(node.pop(jax_name))
            if node:
                raise ValueError(f"{scale}/{conv} has leaves the port cannot map: {sorted(node)}")
    return sd


_INCEPTION_LEAVES = {"conv_kernel": ("conv.weight", _hwio_to_oihw),
                     "bn_scale": ("bn.weight", _tensor), "bn_bias": ("bn.bias", _tensor),
                     "bn_mean": ("bn.running_mean", _tensor),
                     "bn_var": ("bn.running_var", _tensor)}


def inception_state_dict_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """The JAX ``InceptionV3FID`` param tree (each BasicConv2d a node of
    ``conv_kernel`` HWIO and ``bn_{scale,bias,mean,var}``, under
    ``Conv2d_*`` and ``Mixed_*/branch*``) -> torch-fidelity's state-dict
    names, ``<path>.conv.weight`` OIHW and ``<path>.bn.{weight,bias,
    running_mean,running_var}``: the inverse of the JAX package's
    ``_convert_torch_state_dict``. Raises on a node that is not a whole
    BasicConv2d and on a leaf outside one."""
    sd: dict[str, torch.Tensor] = {}

    def walk(node: dict, path: list[str]):
        if any(leaf in node for leaf in _INCEPTION_LEAVES):
            if set(node) != set(_INCEPTION_LEAVES):
                raise ValueError(f"{'/'.join(path)} is not a BasicConv2d: leaves "
                                 f"{sorted(node)}, want {sorted(_INCEPTION_LEAVES)}")
            for jax_name, (torch_name, fn) in _INCEPTION_LEAVES.items():
                sd[".".join(path) + "." + torch_name] = fn(node[jax_name])
            return
        for name, child in node.items():
            if not isinstance(child, dict):
                raise ValueError(f"{'/'.join([*path, name])} is a leaf outside a BasicConv2d")
            walk(child, [*path, name])

    walk(params, [])
    return sd


# --------------------------------------------------------------------------- #
# the port's state_dicts -> JAX param trees (the checkpoint writer's layout)

def _jax_leaf(module: str, name: str, t: torch.Tensor) -> tuple[str, torch.Tensor]:
    """One port leaf -> (its JAX name, the float32 tensor in the JAX layout,
    on the leaf's device): the inverse of the maps above. Transposes and
    flips only, so exact. A leaf already in its JAX layout (a bias) is
    returned as it is, not copied."""
    t = t.detach().float()
    if name == "weight" or name.endswith("_weight"):
        jax_name = name[:-len("weight")] + "kernel"
        if module.startswith("up_"):
            t = t.permute(2, 3, 0, 1).flip(0, 1)
        elif module.rsplit(".", 1)[-1] in ("fc1", "fc2"):
            t = t.T
        else:
            t = t.permute(2, 3, 1, 0)
        return jax_name, t.contiguous()
    return name, t


def jax_tree_from_state_dict(sd: dict[str, torch.Tensor]) -> dict:
    """A port ``state_dict`` (generator or discriminator, or any dict keyed
    like one, e.g. Adam's moments) -> the JAX param tree as nested dicts of
    float32 tensors on the leaves' device: what
    ``generator_state_dict_from_jax`` and
    ``discriminator_state_dict_from_jax`` map back."""
    tree: dict = {}
    for key, value in sd.items():
        module, name = key.rsplit(".", 1)
        node = tree
        for part in module.split("."):
            node = node.setdefault(part, {})
        jax_name, leaf = _jax_leaf(module, name, value)
        node[jax_name] = leaf
    return tree
