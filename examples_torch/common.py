"""Shared helpers for the port's example gallery (headless-friendly).

The gallery of ``mfv2d_torch``: each script solves the problem of its
namesake under ``examples/`` at the same sizes and prints the same
``report`` lines, and plots only where matplotlib is installed.

``DEVICE`` is where every script runs its element work: the CUDA device,
unless ``MFV2D_EXAMPLES_DEVICE`` names another (``cpu``).  Without a card
the default raises in ``solve_system_2d``; it never falls back to the CPU.
The multi-device scripts run one rank per visible card (``spawn_ranks``),
or one gloo rank on the CPU; the smoke's and the tests' multi-rank runs
spawn their ranks through the same function.
"""

from __future__ import annotations

import importlib.util
import os
import queue as queue_module
import socket
import time
import traceback
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch

DEVICE = os.environ.get("MFV2D_EXAMPLES_DEVICE", "cuda")
if DEVICE == "cpu":
    # MKL's batched LU hangs on element blocks of a few hundred rows, and in
    # hp rounds, at more than one thread.
    torch.set_num_threads(1)

# A rank silent this long has hung; its process group times out too.
RANK_TIMEOUT_S = 600


def l2_point_error(grid, name: str, exact) -> float:
    """RMS error of a reconstructed form against an exact function."""
    vals = grid.point_data[name]
    x, y = grid.points[:, 0], grid.points[:, 1]
    ref = np.asarray(exact(x, y))
    if vals.ndim == 2:
        return float(np.sqrt(np.mean(np.sum((vals - ref) ** 2, axis=-1))))
    return float(np.sqrt(np.mean((vals - ref) ** 2)))


def curved_square_deformation(x, y):
    """A smooth deformation standing in for the reference's rmsh B-spline mesh."""
    return (
        x + 0.08 * np.sin(np.pi * x) * np.sin(np.pi * y),
        y - 0.08 * np.sin(np.pi * x) * np.sin(np.pi * y),
    )


def report(title: str, **values) -> None:
    print(f"[{title}] " + "  ".join(f"{k}={v:.4e}" for k, v in values.items()))


# -- multi-device runs ---------------------------------------------------------


def load_script(path):
    """The module of the gallery script at ``path``, imported under a name
    of its own (its ``main`` does not run)."""
    path = Path(path)
    spec = importlib.util.spec_from_file_location(f"_gallery_{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_script(device_mesh, script_file, name: str, *args):
    """A rank's job: ``name(device_mesh, *args)``, a function of the gallery
    script at ``script_file`` (loaded by path, so a rank needs no module
    name for it)."""
    return getattr(load_script(script_file), name)(device_mesh, *args)


def _rank_main(rank, world, port, backend, device, job, args, results):
    """One rank: join the group, call ``job(device_mesh, *args)``, send its
    result (or the traceback) to the parent."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    try:
        if device == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            backend,
            init_method=f"tcp://localhost:{port}",
            world_size=world,
            rank=rank,
            timeout=timedelta(seconds=RANK_TIMEOUT_S),
        )
        try:
            result = job(init_device_mesh(device, (world,)), *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, result))
    except BaseException:
        results.put((rank, traceback.format_exc()))
        raise


def spawn_ranks(
    job, *args, world: int | None = None, backend: str | None = None, device: str | None = None
) -> list:
    """Call ``job(device_mesh, *args)`` on ``world`` spawned ranks and return
    the results by rank.

    ``job`` is a module-level function (the ranks unpickle it by name; a
    gallery script passes ``run_script`` with its own path).  By default
    the ranks run on ``DEVICE``: one rank per visible card over NCCL, or one
    gloo rank on the CPU; ``world``, ``backend`` and ``device`` override
    that (two gloo ranks on one card, say).  A rank that fails, dies or
    stays silent for ``RANK_TIMEOUT_S`` raises."""
    import torch.multiprocessing as mp

    device = device or DEVICE
    if world is None:
        world = torch.cuda.device_count() if device == "cuda" else 1
    if world == 0:
        raise RuntimeError("no CUDA device: set MFV2D_EXAMPLES_DEVICE=cpu to run on the CPU")
    backend = backend or ("nccl" if device == "cuda" else "gloo")
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [
        ctx.Process(
            target=_rank_main,
            args=(r, world, port, backend, device, job, args, results),
        )
        for r in range(world)
    ]
    for proc in procs:
        proc.start()
    out = {}
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        while len(out) < world:
            try:
                rank, result = results.get(timeout=2)
            except queue_module.Empty:
                # A rank that died without a word (at start-up, say) fails
                # the call now rather than at the deadline.
                if time.monotonic() > deadline or any(
                    p.exitcode not in (None, 0) for p in procs
                ):
                    raise RuntimeError(
                        f"{world} rank(s) hung or died: exit codes {[p.exitcode for p in procs]}"
                    ) from None
                continue
            if isinstance(result, str):
                raise RuntimeError(f"rank {rank} of {world} failed:\n{result}")
            out[rank] = result
    finally:
        for proc in procs:
            proc.join(timeout=60)
            if proc.is_alive():
                proc.kill()
                proc.join()
    if any(proc.exitcode != 0 for proc in procs):
        raise RuntimeError(f"rank exit codes {[p.exitcode for p in procs]}")
    return [out[r] for r in range(world)]


# -- gallery figures ---------------------------------------------------------
#
# The figures of the JAX package's gallery, drawn where matplotlib is
# installed and skipped where it is not.  Figure style: sequential = one hue
# light->dark for magnitude fields, diverging = two hues + neutral midpoint
# for signed fields, single-series line plots carry no legend (the title
# names them), recessive grid, labeled axes.

FIGURES_DIR = os.path.join(os.path.dirname(__file__), "_figures")


def _pyplot():
    """matplotlib's pyplot on the Agg backend; None where figures are off
    (``MFV2D_EXAMPLES_FIGURES=0``) or matplotlib is not installed."""
    if os.environ.get("MFV2D_EXAMPLES_FIGURES", "1") == "0":
        return None
    try:
        import matplotlib
    except ImportError:
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def figure_path(script_file: str, label: str) -> str:
    """examples_torch/_figures/<script-stem>_<label>.png"""
    stem = os.path.splitext(os.path.basename(script_file))[0]
    os.makedirs(FIGURES_DIR, exist_ok=True)
    return os.path.join(FIGURES_DIR, f"{stem}_{label}.png")


def save_field_figure(
    grid, name: str, script_file: str, *, label: str | None = None,
    title: str | None = None, diverging: bool | None = None,
) -> str | None:
    """Render one reconstructed field as a filled-triangulation figure.

    Vector fields plot their magnitude.  ``diverging=None`` picks the
    colormap from the data: signed fields get the two-hue diverging map
    centred on zero, non-negative ones a single-hue sequential map.
    """
    plt = _pyplot()
    if plt is None:
        return None
    import matplotlib.tri as mtri

    vals = np.asarray(grid.point_data[name])
    if vals.ndim == 2:
        vals = np.linalg.norm(vals, axis=-1)
    x, y = grid.points[:, 0], grid.points[:, 1]
    tri = mtri.Triangulation(x, y)
    if diverging is None:
        vmax = float(np.abs(vals).max()) or 1.0
        diverging = float(vals.min()) < -0.05 * vmax
    fig, ax = plt.subplots(figsize=(5.2, 4.4), dpi=110)
    if diverging:
        bound = float(np.abs(vals).max()) or 1.0
        m = ax.tripcolor(tri, vals, cmap="RdBu_r", vmin=-bound, vmax=bound,
                         shading="gouraud", rasterized=True)
    else:
        m = ax.tripcolor(tri, vals, cmap="Blues", shading="gouraud",
                         rasterized=True)
    ax.set_aspect("equal")
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.set_title(title or name)
    fig.colorbar(m, ax=ax, shrink=0.9)
    for spine in ax.spines.values():
        spine.set_alpha(0.3)
    out = figure_path(script_file, label or name)
    fig.savefig(out, bbox_inches="tight")
    plt.close(fig)
    return out


def save_convergence_figure(
    xs, errors, script_file: str, *, label: str = "convergence",
    xlabel: str = "polynomial order p", ylabel: str = "L2 error",
    title: str | None = None, logx: bool = False,
) -> str | None:
    """Single-series convergence plot (semilog-y; log-log with ``logx``)."""
    plt = _pyplot()
    if plt is None:
        return None
    fig, ax = plt.subplots(figsize=(4.8, 3.6), dpi=110)
    plot = ax.loglog if logx else ax.semilogy
    plot(xs, errors, "-o", linewidth=2, markersize=6, color="#2a6fb0")
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.set_title(title or "Convergence")
    ax.grid(True, which="both", alpha=0.25, linewidth=0.6)
    for spine in ax.spines.values():
        spine.set_alpha(0.3)
    out = figure_path(script_file, label)
    fig.savefig(out, bbox_inches="tight")
    plt.close(fig)
    return out


def save_history_figure(
    ts, values, script_file: str, *, label: str = "history",
    xlabel: str = "t", ylabel: str = "value", title: str | None = None,
    logy: bool = False,
) -> str | None:
    """Single-series time-history plot (for the unsteady examples)."""
    plt = _pyplot()
    if plt is None:
        return None
    fig, ax = plt.subplots(figsize=(4.8, 3.6), dpi=110)
    plot = ax.semilogy if logy else ax.plot
    plot(ts, values, "-", linewidth=2, color="#2a6fb0")
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.set_title(title or label)
    ax.grid(True, alpha=0.25, linewidth=0.6)
    for spine in ax.spines.values():
        spine.set_alpha(0.3)
    out = figure_path(script_file, label)
    fig.savefig(out, bbox_inches="tight")
    plt.close(fig)
    return out


_STRATEGY_COLORS = ("#2a6fb0", "#e1812c", "#3a923a")  # fixed categorical order


def save_strategies_figure(
    histories, script_file: str, *, label: str = "strategies",
    xlabel: str = "total DoFs", ylabel: str = "L2 error",
    title: str | None = None,
) -> str | None:
    """Multi-strategy error-vs-DoFs figure (log-log; legend + fixed hues).

    ``histories`` maps strategy name -> sequence of (dofs, error) rounds;
    hues are assigned in insertion order and never cycled.
    """
    plt = _pyplot()
    if plt is None:
        return None
    fig, ax = plt.subplots(figsize=(5.0, 3.8), dpi=110)
    for (name, hist), color in zip(histories.items(), _STRATEGY_COLORS):
        dofs = [d for d, _ in hist]
        errs = [e for _, e in hist]
        ax.loglog(dofs, errs, "-o", linewidth=2, markersize=6,
                  color=color, label=name)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.set_title(title or "Refinement strategies")
    ax.grid(True, which="both", alpha=0.25, linewidth=0.6)
    ax.legend(frameon=False)
    for spine in ax.spines.values():
        spine.set_alpha(0.3)
    out = figure_path(script_file, label)
    fig.savefig(out, bbox_inches="tight")
    plt.close(fig)
    return out
