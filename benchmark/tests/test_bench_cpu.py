"""The command on a machine without a card, and cells added by files
alone."""

import json
import shutil
import subprocess
import sys
import time

import pytest
from conftest import BENCH, ROOT

import harness
import manifest
import manifest_rules as rules


def _run(cwd, cell="poisson_64x64_p4_direct"):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed", "2147483659",
         "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300, check=False,
    )


def test_refuses_without_a_card(no_card):
    out = _run(ROOT)
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "CUDA" in out.stderr


def _copy_benchmark(dest):
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(BENCH, dest / BENCH.name, ignore=shutil.ignore_patterns("__pycache__"))


def test_refuses_with_the_benchmark_alone(tmp_path, no_card):
    _copy_benchmark(tmp_path)
    out = _run(tmp_path)
    assert out.returncode != 0 and "{" not in out.stdout


# Each case adds a configuration (a copy of mixed_poisson at a test size), a
# traffic mix, a cell and a per-layer metric by files and entries alone.
# The second runs ``"schur_direct"``, which the inverse's roofline does not
# list, and files its metric under a layer no entry of the repo names.
CASES = {
    "direct": {
        "config": "small_poisson", "traffic": "mesh4_p10_direct", "cell": "poisson_4x4_p10_direct",
        "mesh": 4, "order": 10, "linear_solver": "direct",
        "metric": "window_solves", "reader": "def read(run):\n    return run.solves\n",
        "unit": "solves", "better": "higher", "source": "program_counter", "layer": "mesh",
    },
    "schur_direct_in_a_new_layer": {
        "config": "small_poisson_p8", "traffic": "mesh4_p8_schur_direct",
        "cell": "poisson_4x4_p8_schur_direct", "mesh": 4, "order": 8,
        "linear_solver": "schur_direct", "metric": "schur_factor_s",
        "reader": "def read(run):\n    return run.stage_seconds('picard-solve/schur-factor')\n",
        "unit": "s", "better": "lower", "source": "program_span", "layer": "static condensation",
    },
}


def add_by_files(root, case: dict) -> None:
    """Write ``case``'s files under the benchmark copied to ``root`` and add
    its entries to the copy's BENCHMARK.json."""
    bench = root / BENCH.name
    (bench / "traffic" / f"{case['traffic']}.json").write_text(json.dumps({
        "loop": "closed", "mesh": case["mesh"], "order": case["order"],
        "linear_solver": case["linear_solver"], "recon_order": case["order"],
        "amplitude": [0.04, 0.08]}))
    (bench / "workloads" / f"{case['cell']}.json").write_text(json.dumps({
        "limits": {"points_gap": 1e-12, "u_rms": 1e-9, "q_rms": 1e-9}}))
    (bench / "metrics" / f"{case['metric']}.py").write_text(case["reader"])
    data = json.loads((bench / "configs" / "mixed_poisson.json").read_text())
    data["mesh"], data["orders"] = case["mesh"], [case["order"]]
    (bench / "configs" / f"{case['config']}.json").write_text(json.dumps(data))
    for suffix in (".py", "_reference.py"):
        shutil.copy(bench / "configs" / f"mixed_poisson{suffix}",
                    bench / "configs" / f"{case['config']}{suffix}")
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["configs"].append({"name": case["config"], "source": "https://github.com/j4nr0th/mfv2d",
                         "file": f"benchmark/configs/{case['config']}.json", "reduced": [],
                         "why": "a test"})
    m["workloads"].append({"name": case["cell"], "config": case["config"],
                           "traffic": case["traffic"], "chips": 1, "why": "a test"})
    m["per_layer"].append({"name": case["metric"], "unit": case["unit"], "better": case["better"],
                           "source": case["source"], "layer": case["layer"], "moves": "solve_s",
                           "workloads": [case["cell"]]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))


@pytest.mark.parametrize("case", CASES)
def test_a_cell_and_a_metric_added_by_files_alone(tmp_path, case):
    """A throwaway traffic mix, cell and per-layer metric, each a new file
    and a new entry, pass the manifest rules and run without an edit to any
    file the benchmark has."""
    case = CASES[case]
    _copy_benchmark(tmp_path)
    add_by_files(tmp_path, case)
    rules.check(manifest.load_manifest(tmp_path), tmp_path)

    cell = manifest.load_cell(case["cell"], root=tmp_path)
    assert [x["name"] for x in cell.per_layer if x["name"] == case["metric"]]
    plain = harness.run_cell(cell, 11, 0.5, False, "cpu", time.perf_counter())
    assert plain["correct"] and set(plain["metrics"]) == {"solve_s", "setup_s"}
    traced = harness.run_cell(cell, 12, 0.5, True, "cpu", time.perf_counter())
    assert traced["correct"] and traced["metrics"][case["metric"]]["value"] > 0
    # The metrics of the other cells list them alone.
    assert set(traced["metrics"]) == {case["metric"]}
    assert list(traced)[-1] == "checks"
