"""Packaging contract of the PyTorch port: it imports no JAX, every
subpackage installs, the CUDA sources ship, and its console script
resolves."""

import importlib
import json
import subprocess
import sys
import tomllib
from pathlib import Path

import pytest

REPO_ROOT = Path(__file__).resolve().parents[1]
PKG = "gan_variant_research_tpu_torch"


@pytest.fixture(scope="module")
def pyproject():
    with open(REPO_ROOT / "pyproject.toml", "rb") as f:
        return tomllib.load(f)


def _modules():
    root = REPO_ROOT / PKG
    return sorted(
        ".".join(p.relative_to(REPO_ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in root.rglob("*.py"))


def test_port_imports_no_jax():
    """The machine with the card may have no JAX: importing every module of
    the port in a fresh interpreter must not load jax, flax or optax."""
    code = (
        "import importlib, json, sys\n"
        f"for m in {_modules()!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        "      if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax',\n"
        "                             'gan_variant_research_tpu'))))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []


def test_port_sources_name_no_jax():
    banned = ("import jax", "from jax", "import flax", "from flax", "import optax",
              "from optax", "from gan_variant_research_tpu.",
              "from gan_variant_research_tpu ", "import gan_variant_research_tpu.",
              "import gan_variant_research_tpu ")
    for p in (REPO_ROOT / PKG).rglob("*.py"):
        for line in p.read_text().splitlines():
            stripped = line.strip()
            if stripped.startswith(("import ", "from ")):
                assert not stripped.startswith(banned), f"{p}: {line}"


def test_all_port_subpackages_have_init():
    pkg_root = REPO_ROOT / PKG
    for py in pkg_root.rglob("*.py"):
        d = py.parent
        while d != pkg_root.parent:
            assert (d / "__init__.py").exists(), f"{d} lacks __init__.py"
            d = d.parent


def test_cuda_sources_ship_as_package_data(pyproject):
    globs = pyproject["tool"]["setuptools"]["package-data"][PKG]
    assert globs == ["csrc/*.cu"]
    assert list((REPO_ROOT / PKG).glob(globs[0]))
    assert any(PKG.startswith(inc.rstrip("*"))
               for inc in pyproject["tool"]["setuptools"]["packages"]["find"]["include"])


def test_console_script_resolves(pyproject):
    target = pyproject["project"]["scripts"]["gvr-torch-generate-folder"]
    mod_name, _, attr = target.partition(":")
    assert mod_name == f"{PKG}.cli.generate_folder"
    assert callable(getattr(importlib.import_module(mod_name), attr))


def test_kernel_library_name_tracks_its_source():
    from gan_variant_research_tpu_torch.ops.kernels import _build

    lib = _build.library_path("reflect_conv3x3")
    assert lib.parent == REPO_ROOT / "build" / "torch_kernels"
    assert lib.name.startswith("libreflect_conv3x3-") and lib.suffix == ".so"
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)
