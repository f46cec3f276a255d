"""idle_share.serve: the share of a traced stretch of served batches in which
no operation ran on the card (torch.profiler's device activity)."""

from portbench.readers import idle_share

LAYER = "device"
MOVES = "serve_images_per_s"


def read(ctx: dict):
    return idle_share(ctx)
