"""Mixed-precision policy: bf16 compute with float32 parameters, no loss
scaling. Counterpart of ``gan_variant_research_tpu/core/precision.py``."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    """Parameters are stored in ``param_dtype``; the forward runs in
    ``compute_dtype``."""

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16

    @property
    def enabled(self) -> bool:
        return self.compute_dtype != self.param_dtype


DEFAULT_POLICY = Policy()
FP32_POLICY = Policy(compute_dtype=torch.float32)


def policy_from_config(config: dict) -> Policy:
    """Resolve the policy from ``runtime.precision``; without it, from the
    ``amp`` flag of the CUT (top level or ``io``) or CycleGAN (``training``)
    config shapes, default bf16."""
    runtime = config.get("runtime") or {}
    name = runtime.get("precision")
    if name is None:
        if "amp" in config:
            amp = config["amp"]
        elif "training" in config and "amp" in config["training"]:
            amp = config["training"]["amp"]
        else:
            amp = (config.get("io") or {}).get("amp", True)
        name = "bf16" if amp else "fp32"
    name = str(name).lower()
    if name in ("bf16", "bfloat16", "amp", "mixed"):
        return DEFAULT_POLICY
    if name in ("fp32", "float32", "full"):
        return FP32_POLICY
    raise ValueError(f"Unknown precision policy: {name!r}")
