"""MiFID/FID evaluation of the PyTorch port: the FID InceptionV3 on the
card, the real-stats cache, FID, MiFID, KID, precision/recall, the reports
and the ``gvr-torch-eval`` CLI.

Counterpart of ``gan_variant_research_tpu/evalsuite/`` with its module
names; it imports nothing of the JAX package (the pure-numpy modules are
the port's own copies)."""
