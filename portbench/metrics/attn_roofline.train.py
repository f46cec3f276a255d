"""attn_roofline.train: the attention kernels' bound (forward, dK/dV and dQ of
every attention call in the traced steps, from the configuration's shapes:
``portbench/work/attention.py``) as a share of the device time of the
kernels that ``portbench/readers_attention.py``'s ``KERNELS`` names
(``ops/kernels/spatial_attention.py``'s ``csrc`` kernels). Nothing when the
traced launches differ from those calls."""

from portbench.readers_attention import attention_roofline

LAYER = "attention kernels"
MOVES = "train_images_per_s"


def read(ctx: dict):
    return attention_roofline(ctx)
