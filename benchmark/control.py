"""The control of a cell: the reference, computed in float32, put in the
program's place and judged as a run's answers are.  It has to come out
not correct; a run of the benchmark never runs it.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 [--solves 4]

prints, for each seed, the numbers compared over that many solves of the
seed's traffic beside the cell's limits, and ``correct``.
"""

import argparse
import json
import sys
from itertools import islice
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parent)]

import check  # noqa: E402
import manifest  # noqa: E402
from traffic import amplitudes  # noqa: E402


def control_values(cell: manifest.Cell, seed: int, solves: int) -> dict:
    exact, magnitude = manifest.judged_fields(cell)
    answers = [check.control_answer(cell.traffic, a, exact, magnitude)
               for a in islice(amplitudes(seed, cell.traffic), solves)]
    return check.worst([check.readings(x, cell.traffic, exact, magnitude) for x in answers],
                       cell.limits)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--solves", type=int, default=4)
    args = parser.parse_args(argv)
    cell = manifest.load_cell(args.workload)
    for seed in args.seeds:
        values = control_values(cell, seed, args.solves)
        print(json.dumps({"workload": cell.name, "seed": seed, "correct": check.judge(
            values, cell.limits), "checks": {n: {"value": v, "limit": cell.limits[n]}
                                            for n, v in values.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
