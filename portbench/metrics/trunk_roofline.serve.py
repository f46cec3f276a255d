"""trunk_roofline.serve: the trunk convs' forward bound over the traced
batches (from their shapes) as a share of the device time of the forward
kernels ``KERNELS`` names."""

from portbench.readers import trunk_roofline

LAYER = "trunk kernels"
MOVES = "serve_images_per_s"
KERNELS = r"\b(fwd_main_wgmma|reflect_conv3x3_f32)\b"


def read(ctx: dict):
    return trunk_roofline(ctx, KERNELS)
