"""The harness: ``BENCHMARK.json`` against the contract's rules, files found
by name, and import hygiene."""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
E2E = {m["name"]: m for m in BENCH["end_to_end"]}
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_keys_names_and_units():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [c["name"] for c in BENCH["configs"]] + CELLS + list(E2E) + [
        m["name"] for m in BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for entry in BENCH["configs"]:
        assert set(entry) == {"name", "source", "file", "reduced", "why"}
        assert entry["file"].startswith("portbench/") and (ROOT / entry["file"]).is_file()
        assert all(NAME.match(k) for k in entry["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for n in names:
        assert NAME.match(n), n
    assert all(m["source"] in ("host_clock", "device_trace") for m in E2E.values())
    assert all(0.01 <= m["bound"] <= 0.25 for m in E2E.values())
    assert BENCH["command"] == ["python3", "portbench/run.py"] and BENCH["paths"] == ["portbench"]


def test_each_cell_reports_setup_another_metric_and_a_layer():
    for cell in CELLS:
        loaded = harness.load_cell(cell, ROOT)
        e2e = {m["name"] for m in loaded["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert loaded["per_layer"]


def test_every_moves_names_a_metric_its_cells_report():
    for m in BENCH["per_layer"]:
        assert m["moves"] in E2E
        for cell in m["workloads"]:
            assert cell in E2E[m["moves"]].get("workloads", CELLS)


def test_metric_files_name_their_layer_and_what_they_move():
    cell = harness.load_cell(CELLS[0], ROOT)
    layers = {}
    for m in BENCH["per_layer"]:
        reader = harness.metric_reader(cell, m["name"])
        assert (reader.LAYER, reader.MOVES) == (m["layer"], m["moves"])
        layers.setdefault(m["layer"], set()).add(m["name"])


def test_each_cell_has_its_files_and_limits():
    for cell in CELLS:
        loaded = harness.load_cell(cell, ROOT)
        wl = loaded["workload"]
        assert wl["name"] == cell and wl["config"] == loaded["entry"]["config"]
        assert (ROOT / "portbench" / "drivers" / f"{wl['driver']}.py").is_file()
        known = ({"image_gap"} if wl["driver"] == "serve"
                 else {"loss_gap", "grad_gap", "change_gap", "d_grad_diff"})
        assert wl["limits"] and set(wl["limits"]) <= known


def test_a_new_cell_and_metric_are_found_by_name(tmp_path):
    """A workload, a configuration and a metric dropped into a copy are
    found with no edit to the harness."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    src = harness.load_cell("cut_flagship.serve_b32", ROOT)
    config = dict(src["config"], name="cut_copy")
    (tmp_path / "portbench/configs/cut_copy.json").write_text(json.dumps(config))
    wl = dict(src["workload"], name="cut_copy.serve_b8", config="cut_copy", batch=8)
    (tmp_path / "portbench/workloads/cut_copy.serve_b8.json").write_text(json.dumps(wl))
    (tmp_path / "portbench/metrics/batches.serve.py").write_text(
        'LAYER = "serving step"\nMOVES = "serve_images_per_s"\n\n\n'
        'def read(ctx):\n    return ctx["window"]["calls"]\n')
    bench["configs"].append({"name": "cut_copy", "source": "https://arxiv.org/abs/2007.15651",
                             "file": "portbench/configs/cut_copy.json", "reduced": [],
                             "why": "a copy"})
    bench["workloads"].append({"name": "cut_copy.serve_b8", "config": "cut_copy",
                               "traffic": "serve_b8", "chips": 1, "why": "a copy"})
    bench["per_layer"].append({"name": "batches.serve", "unit": "batches", "better": "higher",
                               "source": "program_counter", "layer": "serving step",
                               "moves": "serve_images_per_s"})
    for m in bench["end_to_end"]:
        if m["name"] == "serve_images_per_s":
            m["workloads"].append("cut_copy.serve_b8")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.load_cell("cut_copy.serve_b8", tmp_path)
    assert cell["workload"]["batch"] == 8 and cell["config"]["name"] == "cut_copy"
    assert "batches.serve" in {m["name"] for m in cell["per_layer"]}
    assert harness.metric_reader(cell, "batches.serve").read({"window": {"calls": 7}}) == 7
    assert harness.driver(cell).__name__ == "portbench_driver_serve"


def _loaded_after(code: str) -> list[str]:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint(sorted(sys.modules))"],
                         capture_output=True, text=True, cwd=ROOT, check=True)
    return eval(out.stdout.strip().splitlines()[-1])


def test_the_harness_and_drivers_load_no_jax():
    code = ("import sys; sys.path.insert(0, '.')\n"
            "from portbench import harness, control\n"
            "import portbench.run\n"
            "cell = harness.load_cell('cut_flagship.train_warmup_b12')\n"
            "for d in ('cut_train', 'cyclegan_train', 'serve'):\n"
            "    cell['workload']['driver'] = d; harness.driver(cell)\n"
            "for m in harness.load_json(harness.ROOT / 'BENCHMARK.json')['per_layer']:\n"
            "    harness.metric_reader(cell, m['name'])\n"
            "import gan_variant_research_tpu_torch.train.cut_trainer\n"
            "import gan_variant_research_tpu_torch.train.cyclegan_trainer\n"
            "import gan_variant_research_tpu_torch.cli.generate_folder\n")
    assert harness.forbidden_modules(_loaded_after(code)) == []


def test_the_reference_loads_nothing_of_the_program():
    loaded = _loaded_after("import sys; sys.path.insert(0, '.')\n"
                           "import portbench.reference.nets, portbench.reference.steps\n"
                           "import portbench.reference.augment")
    top = {m.split(".", 1)[0] for m in loaded}
    assert not top & {"jax", "jaxlib", "flax", "optax", "gan_variant_research_tpu",
                      "gan_variant_research_tpu_torch"}


def test_forbidden_names_are_compared_whole():
    assert harness.forbidden_modules(["gan_variant_research_tpu_torch.ops", "jaxtyping"]) == []
    assert harness.forbidden_modules(["jax.numpy", "gan_variant_research_tpu.core"]) == [
        "gan_variant_research_tpu.core", "jax.numpy"]


@pytest.mark.parametrize("bare", [False, True])
def test_without_a_card_or_the_program_no_result(tmp_path, bare):
    """Here (no CUDA) a run exits non-zero with nothing on stdout; so does
    one in a directory holding only BENCHMARK.json and portbench/."""
    cwd = ROOT
    if bare:
        shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
        cwd = tmp_path
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                           "cut_flagship.serve_b32", "--seed", str(2 ** 31 + 5), "--seconds", "1",
                           "--trace", "0"], capture_output=True, text=True, cwd=cwd)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
