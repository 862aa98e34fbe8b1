"""Run one cell of mfv2d_torch's benchmark once, on the CUDA device.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device``, with ``--trace 1`` a ``breakdown``, and last
``checks``, each number compared beside its limit; the same numbers are the
last lines of standard error.  Without a CUDA device, or with fewer than
the cell asks for, it prints no result and exits with 2; where the JAX
package or JAX itself was loaded, with 3.
"""

import time

CLOCK_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# One process with few threads: the host's BLAS and OpenMP pools at one
# thread each, set before NumPy or torch is imported, whatever the caller's
# environment says.
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = "1"

HERE = Path(__file__).resolve().parent
# The harness's modules, then the checkout's own program ahead of any
# installed copy.
sys.path[:0] = [str(HERE), str(HERE.parent)]

FORBIDDEN = ("jax", "jaxlib", "flax", "mfv2d_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, whole, is a forbidden one."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return parser.parse_args(argv)


def _number(value):
    return value if isinstance(value, (int, float)) and math.isfinite(value) else None


def emit(result: dict) -> None:
    """The numbers compared on standard error, then the result line."""
    for name, entry in result["checks"].items():
        entry["value"] = _number(entry["value"])
        shown = "inf" if entry["value"] is None else repr(entry["value"])
        print(f"check {name} {shown} limit {entry['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def main(argv=None) -> int:
    args = parse_args(argv)
    import manifest

    cell = manifest.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(
            f"run.py: {cell.name} needs {cell.chips} CUDA device(s);"
            f" torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}."
            " No result.",
            file=sys.stderr,
        )
        return 2
    from harness import run_cell

    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", CLOCK_START)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False,
    )
    print(f"card: {card.stdout.strip() or 'nvidia-smi gave nothing'}", flush=True)
    found = forbidden_modules()
    if found:
        print(f"run.py: the run loaded {found}; the benchmark measures mfv2d_torch alone."
              " No result.", file=sys.stderr)
        return 3
    emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
