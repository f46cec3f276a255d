"""attn_ms.train: device ms a traced train step in the attention kernels
(forward, dK/dV, dQ: the names ``portbench/readers_attention.py``'s
``KERNELS`` matches)."""

from portbench.readers_attention import attention_ms

LAYER = "attention kernels"
MOVES = "train_images_per_s"


def read(ctx: dict):
    return attention_ms(ctx)
