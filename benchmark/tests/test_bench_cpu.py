"""The command on a machine without a card, and a cell added by files
alone."""

import json
import shutil
import subprocess
import sys
import time

from conftest import BENCH, ROOT

import harness
import manifest


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


def test_a_cell_and_a_metric_added_by_files_alone(tmp_path):
    """A throwaway traffic mix, cell and per-layer metric, each a new file
    and a new entry, run without an edit to any file the benchmark has."""
    _copy_benchmark(tmp_path)
    bench = tmp_path / BENCH.name
    (bench / "traffic" / "mesh4_p10_direct.json").write_text(json.dumps({
        "loop": "closed", "mesh": 4, "order": 10, "linear_solver": "direct",
        "recon_order": 10, "amplitude": [0.04, 0.08]}))
    (bench / "workloads" / "poisson_4x4_p10_direct.json").write_text(json.dumps({
        "limits": {"points_gap": 1e-12, "u_rms": 1e-9, "q_rms": 1e-9}}))
    (bench / "metrics" / "window_solves.py").write_text(
        "def read(run):\n    return run.solves\n")
    config = bench / "configs" / "mixed_poisson.json"
    data = json.loads(config.read_text())
    data["mesh"], data["orders"] = 4, [10]
    (bench / "configs" / "small_poisson.json").write_text(json.dumps(data))
    for suffix in (".py", "_reference.py"):
        shutil.copy(bench / "configs" / f"mixed_poisson{suffix}",
                    bench / "configs" / f"small_poisson{suffix}")
    m = json.loads((tmp_path / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "small_poisson", "source": "https://github.com/j4nr0th/mfv2d",
                         "file": "benchmark/configs/small_poisson.json", "reduced": [],
                         "why": "a test"})
    m["workloads"].append({"name": "poisson_4x4_p10_direct", "config": "small_poisson",
                           "traffic": "mesh4_p10_direct", "chips": 1, "why": "a test"})
    m["per_layer"].append({"name": "window_solves", "unit": "solves", "better": "higher",
                           "source": "program_counter", "layer": "mesh", "moves": "solve_s",
                           "workloads": ["poisson_4x4_p10_direct"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))

    cell = manifest.load_cell("poisson_4x4_p10_direct", root=tmp_path)
    assert [x["name"] for x in cell.per_layer if x["name"] == "window_solves"]
    plain = harness.run_cell(cell, 11, 0.5, False, "cpu", time.perf_counter())
    assert plain["correct"] and set(plain["metrics"]) == {"solve_s", "setup_s"}
    traced = harness.run_cell(cell, 12, 0.5, True, "cpu", time.perf_counter())
    assert traced["correct"] and traced["metrics"]["window_solves"]["value"] >= 1
    # The metrics of the other cells list them alone.
    assert set(traced["metrics"]) == {"window_solves"}
    assert list(traced)[-1] == "checks"
