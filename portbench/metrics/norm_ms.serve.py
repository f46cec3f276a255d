"""norm_ms.serve: device ms per traced served batch in the instance-norm
kernels (``csrc/instance_norm.cu``'s forward: statistics, finalize and
apply), which ``KERNELS`` names; nothing where no such kernel ran, as on a
program whose norm is stock PyTorch ops."""

from portbench.readers import ms_per_call

LAYER = "norm kernels"
MOVES = "serve_images_per_s"
KERNELS = r"\binorm_(fwd|bwd)_(stats|finalize|apply)\b"


def read(ctx: dict):
    return ms_per_call(ctx, KERNELS) or None
