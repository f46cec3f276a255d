"""trunk_roofline.train: the trunk convs' bound (the forward, input gradient
and weight gradient of every reflect 3 x 3 conv of the residual trunk in
the traced steps, from their shapes: ``portbench/work/flops.py``) as a
share of the device time of the kernels that implement them, which
``KERNELS`` names (``ops/kernels/resblock.py``'s ``csrc`` kernels)."""

from portbench.readers import trunk_roofline

LAYER = "trunk kernels"
MOVES = "train_images_per_s"
KERNELS = (r"\b(fwd_main_wgmma|reflect_conv3x3_f32|dx_main_wgmma|dx_frame_mma|dx_fold|dx_frame"
           r"|dx_main_f32|dw_partial_wgmma|dw_partial_f32|dw_reduce)\b")


def read(ctx: dict):
    return trunk_roofline(ctx, KERNELS)
