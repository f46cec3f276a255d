"""unet_norm_ms.train: device ms a train step in the operations launched
inside the program's ``unet.norm`` spans (``models/generator_unet.py``:
the U-Net's affine instance norms' forward chains, 45 a CycleGAN step), in
the phase stretch (``portbench/phases.py``) over its root spans. The
norms' backward launches on autograd's thread in no span and is not
counted. Nothing where no ``unet.norm`` span ran, as on a program without
them."""

LAYER = "U-Net norms"
MOVES = "train_images_per_s"
SPAN = "unet.norm"


def read(ctx: dict):
    p = ctx.get("phases")
    if not p or not p["roots"] or SPAN not in p["device"]:
        return None
    return p["device"][SPAN] / p["roots"] * 1e3
