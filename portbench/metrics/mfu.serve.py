"""mfu.serve: the window's generator-forward FLOPs over its seconds, as a
share of the card's dense bf16 peak."""

from portbench.readers import mfu

LAYER = "serving step"
MOVES = "serve_images_per_s"


def read(ctx: dict):
    return mfu(ctx)
