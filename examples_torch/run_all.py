"""Run the port's whole example gallery (the de-facto regression suite).

Every script runs on the card (``MFV2D_EXAMPLES_DEVICE=cpu`` runs them on
the CPU).  A script that fails makes the runner exit 1.  The per-script
walls go to ``_figures/timings.txt``.  Two execution modes:

- default (forked): the parent imports torch, scipy and ``mfv2d_torch``
  once, then runs each script in a FORKED child, so no script pays the
  torch import again.  This is safe only because the parent never
  initialises CUDA: a CUDA context does not survive a fork, so each child
  creates its own, and the parent checks before every fork that it has
  none.
- ``--spawn``: one fresh interpreter per script, which measures the cold
  cost of a script, the imports included.
"""

import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))  # repo root for mfv2d_torch and examples_torch


def _run_forked(script: Path) -> int:
    """Execute ``script`` as __main__ in a forked child of this process."""
    import multiprocessing as mp

    import torch

    if torch.cuda.is_initialized():
        raise RuntimeError("the runner initialised CUDA, which a forked child cannot use")

    def target(path):
        import runpy

        sys.argv = [str(path)]
        runpy.run_path(str(path), run_name="__main__")

    proc = mp.get_context("fork").Process(target=target, args=(script,))
    proc.start()
    proc.join()
    return int(proc.exitcode or 0)


def run(scripts, root: Path = HERE, forked: bool = True) -> list[Path]:
    """Run ``scripts`` (paths under ``root``) in order, forked or each in an
    interpreter of its own, and write the walls of those that succeed to
    ``root/_figures/timings.txt``; the scripts that failed."""
    if forked:
        # Imports only: nothing here may touch the card before a fork.
        import scipy  # noqa: F401
        import torch  # noqa: F401

        import examples_torch.common  # noqa: F401
        import mfv2d_torch.solve_system_2d  # noqa: F401

    figures_dir = root / "_figures"
    stems = {s.stem for s in scripts}

    def figs_of(script):
        # A figure belongs to the LONGEST stem that prefixes it (reaction
        # and reaction_mixed share a prefix).
        out = []
        for f in figures_dir.glob(f"{script.stem}_*.png"):
            if any(
                other != script.stem
                and len(other) > len(script.stem)
                and f.stem.startswith(other + "_")
                for other in stems
            ):
                continue
            out.append(f)
        return out

    failures = []
    timings: list[tuple[str, float]] = []
    for script in scripts:
        # Stale figures from a previous run must not mask a regression.
        for f in figs_of(script):
            f.unlink()
        t0 = time.perf_counter()
        if forked:
            rc = _run_forked(script)
        else:
            result = subprocess.run(
                [sys.executable, str(script)], capture_output=True
            )
            rc = result.returncode
        dt = time.perf_counter() - t0
        n_figs = len(figs_of(script))
        status = "OK " if rc == 0 else "FAIL"
        print(f"{status} {script.relative_to(root)}  ({dt:.1f}s, {n_figs} figs)", flush=True)
        if rc == 0:
            timings.append((str(script.relative_to(root)), dt))
        else:
            failures.append(script)
            if not forked:
                print(result.stdout.decode()[-2000:])
                print(result.stderr.decode()[-2000:])
    figures_dir.mkdir(exist_ok=True)
    (figures_dir / "timings.txt").write_text(
        "".join(f"{name} {dt:.2f}\n" for name, dt in timings)
    )
    return failures


def main():
    if run(sorted(HERE.glob("*/*.py")), forked="--spawn" not in sys.argv):
        sys.exit(1)


if __name__ == "__main__":
    main()
