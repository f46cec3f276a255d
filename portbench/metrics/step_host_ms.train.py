"""step_host_ms.train: the median host time of one ``train_step`` call, from
the benchmark's span around the call (its return: the enqueue, not the
device's work)."""

from portbench.readers import host_call_ms

LAYER = "train step"
MOVES = "train_images_per_s"


def read(ctx: dict):
    return host_call_ms(ctx)
