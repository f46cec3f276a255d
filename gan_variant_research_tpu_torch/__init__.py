"""PyTorch / CUDA port of gan_variant_research_tpu for NVIDIA Hopper."""

__version__ = "0.1.0"
