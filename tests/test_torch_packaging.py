"""Packaging contract of the PyTorch port: it imports no JAX (nor PyYAML,
msgpack or matplotlib, which it imports inside the functions that use them),
every subpackage installs, the CUDA sources and the default config ship, and its
console scripts resolve."""

import ctypes
import importlib
import json
import re
import subprocess
import sys
import tomllib
import types
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


# top-level modules the port must not load on import: JAX and the JAX
# package, and PyYAML, msgpack and matplotlib (imported inside functions at
# most)
BANNED_MODULES = ("jax", "jaxlib", "flax", "optax", "gan_variant_research_tpu", "yaml",
                  "msgpack", "matplotlib")


def test_port_imports_no_jax():
    """The machine with the card may have no JAX: importing every module of
    the port in a fresh interpreter must not load jax, flax, optax, the JAX
    package, yaml, msgpack or matplotlib."""
    code = (
        "import importlib, json, sys\n"
        f"for m in {_modules()!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        f"      if m.split('.')[0] in {BANNED_MODULES!r})))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []


TRAIN_SLICE_MODULES = (
    "core.config", "core.prng", "core.trace", "data.augment", "losses.adversarial",
    "losses.patchnce", "losses.reconstruction", "models.attention", "models.discriminator_patchgan",
    "ops.diffaugment", "ops.kernels.spatial_attention", "train.cut_trainer", "train.ema",
    "train.optim", "data.folders", "data.loader", "train.checkpoint", "train.msgpack_codec",
    "train.loss_tracker", "train.plotting", "train.loop", "cli.train_cutpp")


@pytest.mark.parametrize("module", TRAIN_SLICE_MODULES)
def test_train_slice_module_imports_without_jax(module):
    """Each module of the train slice, alone in a fresh interpreter, loads
    no jax, flax, optax, JAX-package, yaml, msgpack or matplotlib module."""
    name = f"{PKG}.{module}"
    assert name in _modules()
    code = (
        "import importlib, json, sys\n"
        f"importlib.import_module({name!r})\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        f"      if m.split('.')[0] in {BANNED_MODULES!r})))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []


EVAL_SLICE_MODULES = ("convert", "evalsuite", "evalsuite.inception", "evalsuite.utils",
                      "evalsuite.datasets", "evalsuite.frechet", "evalsuite.features",
                      "evalsuite.mifid", "evalsuite.kid", "evalsuite.prd", "evalsuite.report",
                      "evalsuite.cli")


@pytest.mark.parametrize("module", EVAL_SLICE_MODULES)
def test_eval_slice_module_imports_without_jax(module):
    """Each module of the eval slice, alone in a fresh interpreter, loads no
    jax, flax, optax, JAX-package, yaml, msgpack or matplotlib module (the
    pure-numpy metrics are the port's own copies)."""
    name = f"{PKG}.{module}"
    assert name in _modules()
    code = (
        "import importlib, json, sys\n"
        f"importlib.import_module({name!r})\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        f"      if m.split('.')[0] in {BANNED_MODULES!r})))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []


CYCLEGAN_SLICE_MODULES = ("models.generator_unet", "train.cyclegan_trainer",
                          "train.cyclegan_loop", "cli.train_cyclegan", "cli.generate_folder")


@pytest.mark.parametrize("module", CYCLEGAN_SLICE_MODULES)
def test_cyclegan_slice_module_imports_without_jax(module):
    """Each module of the CycleGAN slice, alone in a fresh interpreter, loads
    no jax, flax, optax, JAX-package, yaml, msgpack or matplotlib module."""
    name = f"{PKG}.{module}"
    assert name in _modules()
    code = (
        "import importlib, json, sys\n"
        f"importlib.import_module({name!r})\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        f"      if m.split('.')[0] in {BANNED_MODULES!r})))\n"
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
    assert globs == ["csrc/*.cu", "configs/*.yaml"]
    for pattern in globs:
        assert list((REPO_ROOT / PKG).glob(pattern)), pattern
    assert any(PKG.startswith(inc.rstrip("*"))
               for inc in pyproject["tool"]["setuptools"]["packages"]["find"]["include"])


def test_console_script_resolves(pyproject):
    target = pyproject["project"]["scripts"]["gvr-torch-generate-folder"]
    mod_name, _, attr = target.partition(":")
    assert mod_name == f"{PKG}.cli.generate_folder"
    assert callable(getattr(importlib.import_module(mod_name), attr))


def test_train_console_script_resolves(pyproject):
    target = pyproject["project"]["scripts"]["gvr-torch-train-cutpp"]
    mod_name, _, attr = target.partition(":")
    assert mod_name == f"{PKG}.cli.train_cutpp"
    assert callable(getattr(importlib.import_module(mod_name), attr))


def test_eval_console_script_resolves(pyproject):
    target = pyproject["project"]["scripts"]["gvr-torch-eval"]
    mod_name, _, attr = target.partition(":")
    assert mod_name == f"{PKG}.evalsuite.cli"
    assert callable(getattr(importlib.import_module(mod_name), attr))


def test_cyclegan_console_script_resolves(pyproject):
    target = pyproject["project"]["scripts"]["gvr-torch-train-cyclegan"]
    mod_name, _, attr = target.partition(":")
    assert mod_name == f"{PKG}.cli.train_cyclegan"
    assert callable(getattr(importlib.import_module(mod_name), attr))


KERNELS = ["reflect_conv3x3", "reflect_conv3x3_dx", "reflect_conv3x3_dw", "spatial_attention",
           "spatial_attention_dkv", "spatial_attention_dq", "instance_norm"]
# every entry of _build.KERNELS: each source's, and the affine norm's second
# entry in instance_norm.cu
ENTRIES = KERNELS + ["affine_instance_norm"]


@pytest.mark.parametrize("kernel", KERNELS)
def test_kernel_library_name_tracks_its_source(kernel):
    from gan_variant_research_tpu_torch.ops.kernels import _build

    assert (REPO_ROOT / PKG / "csrc" / f"{kernel}.cu").is_file()
    lib = _build.library_path(kernel)
    assert lib.parent == REPO_ROOT / "build" / "torch_kernels"
    assert lib.name.startswith(f"lib{kernel}-") and lib.suffix == ".so"
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)


def _c_parameters(source: str) -> dict[str, list[str]]:
    """The exported functions of a kernel source: each one's name -> for
    each parameter in order, "ptr" or "int"."""
    found = re.findall(r'extern "C" int (\w+)\(([^)]*)\)', source)
    assert found, 'expected an extern "C" int function, found none'
    entries = {}
    for name, params in found:
        kinds = []
        for p in (" ".join(p.split()) for p in params.split(",")):
            if "*" in p:
                kinds.append("ptr")
            elif re.fullmatch(r"(const )?int \w+", p):
                kinds.append("int")
            else:
                raise AssertionError(f"{name}: parameter {p!r} is neither a pointer nor an int")
        entries[name] = kinds
    return entries


def _wrapper_argtypes(monkeypatch) -> dict:
    """What ``_build.kernel`` asks of the libraries for every kernel of its
    table: kernel name -> (the library's source, symbol, ctypes argtypes,
    restype), without building."""
    from gan_variant_research_tpu_torch.ops.kernels import _build

    asked = {}

    class Library:
        def __init__(self, source):
            self.source = source

        def __getattr__(self, symbol):
            fn = types.SimpleNamespace()
            asked[symbol] = (self.source, fn)
            return fn

    monkeypatch.setattr(_build, "load_library", Library)
    loaded = {}
    for name in _build.KERNELS:
        _build.kernel.__wrapped__(name)   # the uncached loader: the real ctypes setup
        symbol = _build.KERNELS[name][0]
        source, fn = asked[symbol]
        loaded[name] = (source, symbol, fn.argtypes, fn.restype)
    return loaded


@pytest.mark.parametrize("kernel", ENTRIES)
def test_kernel_c_signature_matches_its_wrapper(kernel, monkeypatch):
    """The ctypes argtypes ``_build``'s table gives a kernel must match its
    C parameters in count and order (pointers as c_void_p, ints as c_int, the
    stream last): a mismatch corrupts memory on the card, where no CPU test
    runs the kernel. Every exported function of a source is in the table."""
    assert sorted(p.stem for p in (REPO_ROOT / PKG / "csrc").glob("*.cu")) == sorted(KERNELS)
    loaded = _wrapper_argtypes(monkeypatch)
    assert sorted(loaded) == sorted(ENTRIES)
    source, symbol, argtypes, restype = loaded[kernel]
    entries = _c_parameters((REPO_ROOT / PKG / "csrc" / f"{source}.cu").read_text())
    assert sorted(entries) == sorted(s for src, s, _, _ in loaded.values() if src == source)
    kinds = entries[symbol]
    assert restype is ctypes.c_int
    as_kinds = [{ctypes.c_void_p: "ptr", ctypes.c_int: "int"}[t] for t in argtypes]
    assert as_kinds == kinds
    assert kinds[-1] == "ptr"   # the stream
    if kernel == "reflect_conv3x3":
        # the last int is the route, an index into resblock.TRUNK_ROUTES
        source = (REPO_ROOT / PKG / "csrc" / f"{kernel}.cu").read_text()
        assert re.search(r"int Cin, int Cout, int route,\s*void\* stream\)", source)
        # and the C entry launches the wgmma route at that route's index, the
        # float32 kernel at the other
        from gan_variant_research_tpu_torch.ops.kernels import resblock

        assert re.search(rf"route == {resblock.TRUNK_ROUTES.index('bf16_wgmma')}\) return launch_wgmma",
                         source)
        assert re.search(rf"route != {resblock.TRUNK_ROUTES.index('f32_fma')}\) return[^;]*;"
                         r"[^}]*reflect_conv3x3_f32<<<", source)
    if kernel == "reflect_conv3x3_dx":
        # the last int is the route, an index into resblock.TRUNK_ROUTES
        source = (REPO_ROOT / PKG / "csrc" / f"{kernel}.cu").read_text()
        assert re.search(r"int Cout, int route,\s*void\* stream\)", source)
        # and the C entry launches the wgmma route at that route's index
        from gan_variant_research_tpu_torch.ops.kernels import resblock

        assert re.search(rf"route == {resblock.TRUNK_ROUTES.index('bf16_wgmma')}\) return launch_wgmma",
                         source)
    if kernel == "reflect_conv3x3_dw":
        # likewise the dw kernel's last int, an index into resblock.TRUNK_ROUTES
        source = (REPO_ROOT / PKG / "csrc" / f"{kernel}.cu").read_text()
        assert re.search(r"int Cout, int S, int route, void\* stream\)", source)
        from gan_variant_research_tpu_torch.ops.kernels import resblock

        assert re.search(rf"route == {resblock.TRUNK_ROUTES.index('f32_fma')}\) {{\s*const dim3 grid"
                         rf"[^}}]*dw_partial_f32", source)
        assert re.search(rf"route == {resblock.TRUNK_ROUTES.index('bf16_wgmma')}\) {{\s*const int err = "
                         "launch_wgmma", source)


def _probe(op: str):
    spec = importlib.util.spec_from_file_location(f"probe_torch_{op}",
                                                  REPO_ROOT / "scripts" / f"probe_torch_{op}.py")
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    return probe, (REPO_ROOT / PKG / "csrc" / f"reflect_conv3x3_{op}.cu").read_text()


def test_dx_probe_variants_apply_to_the_kernel_source():
    """scripts/probe_torch_dx.py builds its variants of the dx kernel by text
    edits of csrc/reflect_conv3x3_dx.cu: each edit must still find its text,
    so that an edit of the kernel that breaks the probe shows here."""
    probe, source = _probe("dx")
    assert probe.variant_source(source, "base") == source
    for variant in [*probe.EDITS, *probe.DEFAULT]:
        edited = probe.variant_source(source, variant)
        assert variant == "base" or edited != source


def test_fwd_probe_variants_apply_to_the_kernel_source():
    """The same for scripts/probe_torch_fwd.py and csrc/reflect_conv3x3.cu:
    every edit finds its text exactly once, so that it changes the wgmma
    route and nothing else."""
    spec = importlib.util.spec_from_file_location("probe_torch_fwd",
                                                  REPO_ROOT / "scripts" / "probe_torch_fwd.py")
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    source = (REPO_ROOT / PKG / "csrc" / "reflect_conv3x3.cu").read_text()
    assert probe.variant_source(source, "base") == source
    for variant in [*probe.EDITS, *probe.DEFAULT]:
        edited = probe.variant_source(source, variant)
        assert variant == "base" or edited != source
        for old, _ in probe.EDITS[variant.split("+")[0]]:
            assert source.count(old) == 1, (variant, old)


def test_dw_probe_variants_apply_to_the_kernel_source():
    """The same for scripts/probe_torch_dw.py and csrc/reflect_conv3x3_dw.cu:
    every edit finds its text exactly once, so that it changes the wgmma
    route and nothing else."""
    probe, source = _probe("dw")
    assert probe.variant_source(source, "base") == source
    for variant in [*probe.EDITS, *probe.DEFAULT]:
        edited = probe.variant_source(source, variant)
        assert variant == "base" or edited != source
        for old, _ in probe.EDITS[variant.split("+")[0]]:
            assert source.count(old) == 1, (variant, old)


def test_dq_probe_variants_apply_to_the_kernel_source():
    """The same for scripts/probe_torch_dq.py and csrc/spatial_attention_dq.cu:
    every edit of every variant (joined ones too) finds its text exactly
    once, so that it changes the wgmma kernel and nothing else."""
    spec = importlib.util.spec_from_file_location("probe_torch_dq",
                                                  REPO_ROOT / "scripts" / "probe_torch_dq.py")
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    source = (REPO_ROOT / PKG / "csrc" / "spatial_attention_dq.cu").read_text()
    assert probe.variant_source(source, "base") == source
    for variant in [*probe.EDITS, *probe.DEFAULT]:
        edited = probe.variant_source(source, variant)
        assert variant == "base" or edited != source
        for name in variant.split("+"):
            for old, _ in probe.EDITS[name]:
                assert source.count(old) == 1, (variant, old)
