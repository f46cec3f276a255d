"""step_span_ms.train: the median host time of one train step from the
program's own root span (``cut.step`` / ``cyclegan.step``,
``core/trace.py``) in the span stretch (``portbench/phases.py``): the
step's enqueue, measured inside the program."""

from portbench.phases import step_span_ms

LAYER = "train step"
MOVES = "train_images_per_s"


def read(ctx: dict):
    return step_span_ms(ctx)
