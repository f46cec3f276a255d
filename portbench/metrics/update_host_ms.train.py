"""update_host_ms.train: host ms a train step in the optimizer layer, the
spans ``optim.clip``, ``optim.adam`` (``train/optim.py``) and
``ema.update`` (``train/ema.py``) summed over the span stretch's root
spans (``portbench/phases.py``): the per-leaf update loops' launches."""

from portbench.phases import UPDATES, host_ms_per_step

LAYER = "optimizer"
MOVES = "train_images_per_s"


def read(ctx: dict):
    return host_ms_per_step(ctx, lambda name: name in UPDATES)
