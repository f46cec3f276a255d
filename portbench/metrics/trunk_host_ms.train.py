"""trunk_host_ms.train: host ms a train step in the trunk kernels'
wrappers, the spans ``trunk.fwd``, ``trunk.dx`` and ``trunk.dw``
(``ops/kernels/resblock.py``: checks, channel padding, allocation, the
ctypes launch) summed over the span stretch's root spans
(``portbench/phases.py``)."""

from portbench.phases import host_ms_per_step

LAYER = "trunk kernels"
MOVES = "train_images_per_s"


def read(ctx: dict):
    return host_ms_per_step(ctx, lambda name: name.startswith("trunk."))
