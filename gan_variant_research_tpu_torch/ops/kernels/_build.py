"""Build the hand-written CUDA kernels at first use, load them, and launch
them: the one seam between the kernel wrappers and ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface, declared once in
``KERNELS``: pointers, then ints, then the stream, returning a CUDA error
code; a second entry of one source (the affine norm's, in
``instance_norm.cu``) names its source in ``SOURCES``. A source is
compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``build/torch_kernels/`` beside the package, and loaded with ``ctypes``.
The library's file name carries a hash of the source and the flags, so an
edited source rebuilds. Nothing is built when a module is
imported: the CPU path never calls this.

``launch`` finds its kernel through the module attribute ``kernel`` at each
call, so a script that times a variant build swaps ``kernel`` for a function
that returns ``bind(ctypes.CDLL(variant), name)``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# csrc/<name>.cu -> (its extern "C" symbol, pointer count, int count)
KERNELS = {
    "reflect_conv3x3": ("reflect_conv3x3_forward", 4, 6),
    "reflect_conv3x3_dx": ("reflect_conv3x3_dx", 4, 6),
    "reflect_conv3x3_dw": ("reflect_conv3x3_dw", 5, 7),
    "spatial_attention": ("spatial_attention_forward", 5, 5),
    "spatial_attention_dkv": ("spatial_attention_dkv", 8, 5),
    "spatial_attention_dq": ("spatial_attention_dq", 7, 5),
    "instance_norm": ("instance_norm", 5, 7),
    "affine_instance_norm": ("affine_instance_norm", 8, 7),
}
# an entry of another kernel's source -> that source's name
SOURCES = {"affine_instance_norm": "instance_norm"}
# the kernels' dtype argument, and the grid's z limit (the batch, or splits)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
GRID_Z_MAX = 65535


def find_nvcc() -> str:
    """``nvcc`` on PATH, else under /usr/local/cuda/bin; raises if neither."""
    nvcc = shutil.which("nvcc")
    if nvcc is None and Path("/usr/local/cuda/bin/nvcc").is_file():
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found on PATH or under /usr/local/cuda/bin; "
                           "the CUDA kernels cannot be built")
    return nvcc


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def load_library(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` unless its hashed library exists, then load it.

    The compiler's report (registers, shared memory, spills) goes to
    ``<library>.log``."""
    out = library_path(name)
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
        os.close(fd)
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
        os.replace(tmp, out)
    return ctypes.CDLL(str(out))


def bind(lib: ctypes.CDLL, name: str):
    """Kernel ``name``'s entry in ``lib``, with its ctypes signature from
    ``KERNELS``."""
    symbol, n_ptr, n_int = KERNELS[name]
    fn = getattr(lib, symbol)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def kernel(name: str):
    """Kernel ``name``'s entry, its source built and loaded at the first
    call."""
    return bind(load_library(SOURCES.get(name, name)), name)


@functools.cache
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def launch(name: str, device: torch.device, *args: int) -> None:
    """Kernel ``name`` on ``device``'s current stream with ``args`` (its
    pointers, then its ints); raises if it returns a CUDA error."""
    with torch.cuda.device(device):
        err = kernel(name)(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
