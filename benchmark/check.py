"""The comparison that decides ``correct``.

Every solve returns a reconstructed grid: points and the fields at them.
The reference works out the points itself, from the amplitude the solve was
given and the frozen deformation, and evaluates the configuration's
closed-form solution there.  It reads the program's grid only to judge it.
The numbers compared, each the worst over a run's solves:

- ``points_gap``: the largest distance of a grid point from the reference's
  point (infinite where the number of points differs);
- ``<field>_rms``: for each field of the configuration's reference, the RMS
  of the program's error over the points, over the RMS of the exact field;
- ``<field>_max``: for each field the reference names in
  ``MAGNITUDE_FIELDS``, whose exact value is zero to within the
  configuration's discretization error (so a ratio to its RMS has no
  meaning), the largest absolute value over the points.

Each reads infinite where the field is absent, has another number of
points than the reference or is not finite.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from traffic import curved_square


@dataclass
class Answer:
    """What one solve returned, kept on the host until the window closes."""

    amplitude: float
    points: np.ndarray
    fields: dict


def reference_points(mesh: int, recon_order: int, amplitude: float, dtype=np.float64) -> np.ndarray:
    """The grid points of a ``mesh`` x ``mesh`` curved square: per element,
    in row-major element order, ``(recon_order + 1)^2`` points evenly spaced
    in the reference square and mapped bilinearly from its corners."""
    line = np.linspace(-1, 1, mesh + 1).astype(dtype)
    x, y = curved_square(amplitude)(*np.meshgrid(line, line))
    x, y = np.asarray(x, dtype), np.asarray(y, dtype)
    nodes = np.linspace(-1, 1, recon_order + 1).astype(dtype)
    xi, eta = nodes[None, :], nodes[:, None]
    b11, b12 = (1 - xi) / 2, (1 + xi) / 2
    b21, b22 = (1 - eta) / 2, (1 + eta) / 2

    def mapped(c):
        # Corners 0..3: (i, j), (i + 1, j), (i + 1, j + 1), (i, j + 1).
        c0 = c[:-1, :-1].reshape(-1, 1, 1)
        c1 = c[:-1, 1:].reshape(-1, 1, 1)
        c2 = c[1:, 1:].reshape(-1, 1, 1)
        c3 = c[1:, :-1].reshape(-1, 1, 1)
        return ((c0 * b11 + c1 * b12) * b21 + (c3 * b11 + c2 * b12) * b22).reshape(-1)

    return np.stack((mapped(x), mapped(y)), axis=-1)


def readings(answer: Answer, traffic: dict, exact: dict, magnitude=()) -> dict[str, float]:
    """The numbers compared for one solve, against the f64 reference: the
    fields of ``exact`` by their closed form, those named in ``magnitude``
    by their size."""
    ref = reference_points(traffic["mesh"], traffic["recon_order"], answer.amplitude)
    points = np.asarray(answer.points)[:, :2]
    out = {"points_gap": np.inf}
    if points.shape == ref.shape:
        out["points_gap"] = float(np.abs(points - ref).max())
    x, y = ref[:, 0], ref[:, 1]
    for name, field in exact.items():
        want = np.asarray(field(x, y), np.float64)
        got = answer.fields.get(name)
        value = np.inf
        if got is not None and np.shape(got) == want.shape:
            err = np.asarray(got, np.float64) - want
            value = float(np.sqrt(np.mean(err**2)) / np.sqrt(np.mean(want**2)))
        out[f"{name}_rms"] = value if np.isfinite(value) else np.inf
    for name in magnitude:
        got = answer.fields.get(name)
        value = np.inf
        if got is not None and np.ndim(got) >= 1 and np.shape(got)[0] == len(ref):
            value = float(np.abs(np.asarray(got, np.float64)).max())
        out[f"{name}_max"] = value if np.isfinite(value) else np.inf
    return out


def worst(per_answer: list[dict[str, float]], names) -> dict[str, float]:
    """Each number's worst reading over the answers (infinite where there
    are none)."""
    return {n: max((r[n] for r in per_answer), default=np.inf) for n in names}


def judge(values: dict[str, float], limits: dict[str, float]) -> bool:
    """True where every number compared is within its limit."""
    return all(values.get(name, np.inf) <= limit for name, limit in limits.items())


def control_answer(traffic: dict, amplitude: float, exact: dict, magnitude=()) -> Answer:
    """The control: the reference put in the program's place, computed in
    float32, the precision below the configuration's float64.  A field held
    by magnitude is its exact value, float32 zeros: the control fails on the
    closed-form fields."""
    points = reference_points(traffic["mesh"], traffic["recon_order"], amplitude, np.float32)
    x, y = points[:, 0], points[:, 1]
    fields = {name: np.asarray(field(x, y)) for name, field in exact.items()}
    fields.update({name: np.zeros(len(points), np.float32) for name in magnitude})
    for name, values in fields.items():
        if values.dtype != np.float32:
            raise TypeError(f"the control's {name} came out in {values.dtype}, not float32")
    return Answer(amplitude, points, fields)
