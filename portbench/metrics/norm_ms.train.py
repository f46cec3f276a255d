"""norm_ms.train: device ms per traced train step in the instance-norm
kernels (``csrc/instance_norm.cu``: statistics, finalize and apply, forward
and backward), which ``KERNELS`` names; nothing where no such kernel ran, as
on a program whose norm is stock PyTorch ops."""

from portbench.readers import ms_per_call

LAYER = "norm kernels"
MOVES = "train_images_per_s"
KERNELS = r"\binorm_(fwd|bwd)_(stats|finalize|apply)\b"


def read(ctx: dict):
    return ms_per_call(ctx, KERNELS) or None
