"""launches.train: device operations (kernels, copies, sets) launched a
train step, those whose launching call falls inside a root span of the
phase stretch (``portbench/phases.py``, torch.profiler's kineto events)
over the root spans."""

from portbench.phases import launches_per_step

LAYER = "train step"
MOVES = "train_images_per_s"


def read(ctx: dict):
    return launches_per_step(ctx)
