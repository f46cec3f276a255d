"""mfu.train: the window's model FLOPs (``portbench/work/flops.py``, from the
configuration's shapes) over its seconds, as a share of the card's dense
bf16 peak: the whole train step's utilisation, which bounds every
kernel's gain."""

from portbench.readers import mfu

LAYER = "train step"
MOVES = "train_images_per_s"


def read(ctx: dict):
    return mfu(ctx)
