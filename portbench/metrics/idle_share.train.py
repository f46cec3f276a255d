"""idle_share.train: the share of a traced stretch of training steps in which
no operation ran on the card (torch.profiler's device activity)."""

from portbench.readers import idle_share

LAYER = "device"
MOVES = "train_images_per_s"


def read(ctx: dict):
    return idle_share(ctx)
