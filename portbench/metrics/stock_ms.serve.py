"""stock_ms.serve: device ms per served batch in stock kernels: PyTorch's
own (``at::``, CUB), cuDNN's and cuBLAS's, and the batch's copies, classed
by the name patterns of ``STOCK``. A kernel of the port's own (``csrc/``,
Triton) matches none."""

from portbench.readers import ms_per_call

LAYER = "stock ops"
MOVES = "serve_images_per_s"
STOCK = (r"at::|at_cuda_detail|cudnn|cutlass|xmma|cublas|gemm|gemv|implicit_convolve"
         r"|nchwToNhwc|nhwcToNchw|winograd|fft|dgrad|wgrad|fprop|conv2d_grouped|Memset|Memcpy")


def read(ctx: dict):
    return ms_per_call(ctx, STOCK)
