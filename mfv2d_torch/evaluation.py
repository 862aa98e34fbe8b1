"""Batched evaluation of compiled k-form systems.

The reference executes a bytecode block per element inside a C interpreter
(src/evaluation/element_eval.c:399-479, element_system.c:13-212).  Here the
same op semantics run eagerly over an ``[E, ...]`` batch of same-order
elements, so every op is one batched tensor operation for the entire mesh
bucket instead of ``n_elem x n_forms^2`` interpreter calls.

Lazy-composition rules mirror the C ``matrix_t`` union: identities and
incidence matrices stay symbolic until a dense matrix forces materialization
(element_eval.c:117-177).

The JAX package wraps these functions in shape-keyed ``jax.jit`` caches with
power-of-two element padding and per-dispatch chunk caps (``_pad_pow2``,
``_pow2``, ``_cached_*_fn``), which exist to reuse compiled programs and to
bound TPU memory per program.  PyTorch runs eagerly and compiles nothing, so
the port calls the functions below directly on each bucket.
"""

from __future__ import annotations

from collections.abc import Sequence
from functools import lru_cache

import numpy as np
import torch

from mfv2d_torch.compiler import (
    Identity,
    Incidence,
    InterProd,
    MassMat,
    Push,
    Scale,
    Sum,
    SystemBlocks,
)
from mfv2d_torch.kform import UnknownFormOrder
from mfv2d_torch.ops.basis import Basis2D
from mfv2d_torch.ops.incidence import (
    INCIDENCE_E10,
    INCIDENCE_E10_T,
    INCIDENCE_E21,
    INCIDENCE_E21_T,
    incidence_matrix,
)
from mfv2d_torch.ops.kernels import gj_inverse as gj_inverse_kernel
from mfv2d_torch.ops.kernels import mass_edge as mass_edge_kernel
from mfv2d_torch.ops.mass import (
    TensorBasis,
    batch_jacobian,
    mass_edge_double,
    mass_edge_surf,
    mass_node,
    mass_node_double,
    mass_node_edge,
    mass_surf,
    mass_surf_double,
    tensor_basis,
)
from mfv2d_torch.system import ElementFormSpecification
from mfv2d_torch.transfer import to_device, to_host


def check_device(device) -> torch.device:
    """``device`` as a ``torch.device``.  A CUDA device must be present: the
    port never falls back to the CPU unless the caller asks for it."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "mfv2d_torch runs on the CUDA device by default and none is"
            ' available; pass device="cpu" to run on the CPU.'
        )
    return device


def _mass_solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched solve ``A X = B`` for mass matrices."""
    return torch.linalg.solve(a, b)


def _mass_inverse(a: torch.Tensor) -> torch.Tensor:
    """Batched inverse of mass matrices: the pivoted Gauss-Jordan kernel on
    CUDA tensors, a solve against the identity (see _mass_solve) on the CPU."""
    if a.device.type == "cuda":
        return gj_inverse_kernel.gj_inverse(a.contiguous())
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device).expand(a.shape)
    return _mass_solve(a, eye)


class ElementBatch:
    """A batch of elements sharing basis orders and integration rules.

    Holds the per-batch geometry (Jacobian terms at quadrature points, in
    float64 on ``device``: the CUDA device unless the caller asks for
    ``"cpu"``) and memoizes mass matrices/inverses.  The
    geometry of a batch never changes, so the memo is reused across Picard
    iterations (the reference's per-element lazy mass cache,
    element_fem_space.c:445-469, amortized over the whole batch).
    """

    def __init__(self, basis: Basis2D, corners, device="cuda") -> None:
        self.basis = basis
        self.tb: TensorBasis = tensor_basis(basis)
        self.device = check_device(device)
        corners_np = np.asarray(corners, np.float64)
        if corners_np.ndim == 2:
            corners_np = corners_np[None]
        # Host copy for the NumPy paths (static fields, forcing, output).
        self.corners_np = corners_np
        self.corners = to_device(corners_np, self.device, torch.float64, copy=True)
        self.n_elements = corners_np.shape[0]
        self._jac = None
        self._mass: dict[tuple[int, bool], torch.Tensor] = {}

    @property
    def jac(self):
        if self._jac is None:
            self._jac = batch_jacobian(self.tb, self.corners)
        return self._jac

    @property
    def orders(self) -> tuple[int, int]:
        return (self.tb.p1, self.tb.p2)

    @property
    def n_quad(self) -> int:
        return self.tb.w.size

    def mass(self, order: UnknownFormOrder, inv: bool) -> torch.Tensor:
        """Memoized batched mass matrix (or inverse) of the given form order.

        1-form masses go through the hand-written kernel on CUDA tensors
        (its plain version on CPU tensors).
        """
        key = (int(order), bool(inv))
        if key not in self._mass:
            if not inv:
                if order == UnknownFormOrder.FORM_ORDER_0:
                    m = mass_node(self.tb, self.jac)
                elif order == UnknownFormOrder.FORM_ORDER_1:
                    m = mass_edge_kernel.mass_edge(self.tb, self.jac)
                elif order == UnknownFormOrder.FORM_ORDER_2:
                    m = mass_surf(self.tb, self.jac)
                else:
                    raise ValueError(f"Invalid mass order {order}.")
            else:
                m = _mass_inverse(self.mass(order, False))
            self._mass[key] = m
        return self._mass[key]

    def reconstruct_one_form(self, dofs: torch.Tensor) -> torch.Tensor:
        """Physical (x, y) components of a 1-form at quadrature points.

        ``dofs`` is ``[E, n1]`` in the [h, v] layout; returns ``[E, nq, 2]``
        (the batched equivalent of integrating_fields.c:13-353 /
        mimetic2d.reconstruct for 1-forms).
        """
        tb = self.tb
        n_h = tb.bh.shape[0]
        c_h = dofs[:, :n_h]
        c_v = dofs[:, n_h:]
        out_eta = c_h @ tb.tensor("bh", dofs)
        out_xi = c_v @ tb.tensor("bv", dofs)
        jac = self.jac
        fx = (out_xi * jac.j00 + out_eta * jac.j10) / jac.det
        fy = (out_xi * jac.j01 + out_eta * jac.j11) / jac.det
        return torch.stack([fx, fy], dim=-1)


def _incidence_kind(begin: UnknownFormOrder, transpose) -> int:
    return {
        (int(UnknownFormOrder.FORM_ORDER_0), False): INCIDENCE_E10,
        (int(UnknownFormOrder.FORM_ORDER_1), False): INCIDENCE_E21,
        (int(UnknownFormOrder.FORM_ORDER_0), True): INCIDENCE_E10_T,
        (int(UnknownFormOrder.FORM_ORDER_1), True): INCIDENCE_E21_T,
    }[(int(begin), bool(transpose))]


def _incidence_tensor(batch: ElementBatch, incs: tuple, like: torch.Tensor) -> torch.Tensor:
    """The product of the incidence matrices ``incs``, each a ``(begin,
    transpose)`` pair, left to right, at the batch's orders, in ``like``'s
    dtype on its device: from the basis's device tables."""
    tb = batch.tb
    kinds = tuple(_incidence_kind(*inc) for inc in incs)

    def product() -> np.ndarray:
        mats = [incidence_matrix(kind, tb.p1, tb.p2) for kind in kinds]
        out = mats[0]
        for mat in mats[1:]:
            out = out @ mat
        return out

    return tb.tables.like(("incidence", *kinds), product, like)


def _interprod_matrix(
    batch: ElementBatch, op: InterProd, fields: dict
) -> tuple[torch.Tensor, float]:
    """Field-weighted interior-product matrix and its sign coefficient.

    Matches element_eval.c:311-397: starting order 1 -> node_edge with +1,
    starting order 2 -> edge_surf with -1.
    """
    field = fields[op.field]
    if op.starting_order == UnknownFormOrder.FORM_ORDER_1:
        return mass_node_edge(batch.tb, batch.jac, field, op.transpose), +1.0
    if op.starting_order == UnknownFormOrder.FORM_ORDER_2:
        return mass_edge_surf(batch.tb, batch.jac, field, op.transpose), -1.0
    raise ValueError(
        f"InterProd starting order must be 1- or 2-form, got {op.starting_order}."
    )


class _State:
    """Lazy 'current matrix' of the stack machine.

    kind: 'invalid' | 'identity' | 'incidence' | 'full'
    For vectors the full payload is ``[E, n]``; for matrices ``[E, r, c]``.
    Payloads may alias memoized masses and cached device tables, so they
    are never modified in place.
    """

    __slots__ = ("kind", "coef", "payload", "inc")

    def __init__(self, kind="invalid", coef=0.0, payload=None, inc=None):
        self.kind = kind
        self.coef = coef
        self.payload = payload
        self.inc = inc  # (begin_order, transpose) for incidence

    def copy(self) -> "_State":
        return _State(self.kind, self.coef, self.payload, self.inc)


def _left_apply_incidence(inc: tuple, state: _State, batch: ElementBatch) -> _State:
    """Left-multiply the state by the incidence matrix ``inc``, a ``(begin,
    transpose)`` pair."""
    det = batch.jac.det
    e = batch.n_elements
    if state.kind in ("invalid", "identity"):
        m = _incidence_tensor(batch, (inc,), det)
        coef = state.coef if state.kind == "identity" else 1.0
        return _State("full", coef, m.expand((e,) + tuple(m.shape)))
    if state.kind == "incidence":
        prod = _incidence_tensor(batch, (inc, state.inc), det)
        return _State("full", state.coef, prod.expand((e,) + tuple(prod.shape)))
    if state.kind == "full":
        m = _incidence_tensor(batch, (inc,), det)
        if state.payload.ndim == 2:  # vector [E, n]
            return _State("full", state.coef, state.payload @ m.T)
        return _State("full", state.coef, torch.matmul(m, state.payload))
    raise RuntimeError(f"Bad state {state.kind}")


def _left_apply_batched(mat: torch.Tensor, state: _State, batch: ElementBatch) -> _State:
    """Left-multiply the state by a batched ``[E, r, c]`` matrix."""
    if state.kind in ("invalid", "identity"):
        coef = state.coef if state.kind == "identity" else 1.0
        return _State("full", coef, mat)
    if state.kind == "incidence":
        e_mat = _incidence_tensor(batch, (state.inc,), mat)
        return _State("full", state.coef, torch.matmul(mat, e_mat))
    if state.kind == "full":
        if state.payload.ndim == 2:
            return _State(
                "full", state.coef, torch.matmul(mat, state.payload[..., None])[..., 0]
            )
        return _State("full", state.coef, torch.matmul(mat, state.payload))
    raise RuntimeError(f"Bad state {state.kind}")


def _materialize(
    state: _State,
    batch: ElementBatch,
    n_cols: int,
    vector: bool,
    initial,
) -> torch.Tensor:
    """Turn the lazy state into a dense ``[E, r, c]`` matrix or ``[E, n]`` vector."""
    e = batch.n_elements
    det = batch.jac.det
    if state.kind == "invalid":
        raise RuntimeError("Block evaluated to an invalid state.")
    if state.kind == "identity":
        if vector:
            return state.coef * initial
        eye = torch.eye(n_cols, dtype=det.dtype, device=det.device)
        return state.coef * eye.expand(e, n_cols, n_cols)
    if state.kind == "incidence":
        e_mat = _incidence_tensor(batch, (state.inc,), det)
        if vector:
            return state.coef * (initial @ e_mat.T)
        return state.coef * e_mat.expand((e,) + tuple(e_mat.shape))
    arr = state.payload
    if state.coef != 1.0:
        arr = state.coef * arr
    return arr


def evaluate_block(
    ops: Sequence,
    batch: ElementBatch,
    fields: dict,
    n_cols: int,
    initial=None,
) -> torch.Tensor:
    """Evaluate one bytecode block over the batch.

    With ``initial`` (an ``[E, n_cols]`` vector) the result is the block
    applied to that vector (``compute_element_vector`` semantics, each Push
    re-seeds with the initial operand); otherwise the dense block matrix.
    """
    vector = initial is not None

    def fresh() -> _State:
        if vector:
            return _State("full", 1.0, initial)
        return _State("invalid", 0.0)

    current = fresh()
    stack: list[_State] = []

    for op in ops:
        t = type(op)
        if t is Identity:
            if current.kind == "invalid":
                current = _State("identity", 1.0)
        elif t is Scale:
            if current.kind == "invalid":
                current = _State("identity", op.k)
            else:
                current = current.copy()
                current.coef = current.coef * op.k
        elif t is Push:
            stack.append(current)
            current = fresh()
        elif t is Incidence:
            if current.kind in ("invalid", "identity"):
                coef = current.coef if current.kind == "identity" else 1.0
                current = _State("incidence", coef, inc=(op.begin, bool(op.transpose)))
            else:
                current = _left_apply_incidence((op.begin, bool(op.transpose)), current, batch)
        elif t is MassMat:
            m = batch.mass(op.order, op.inv)
            current = _left_apply_batched(m, current, batch)
        elif t is InterProd:
            m, sign = _interprod_matrix(batch, op, fields)
            current = _left_apply_batched(m, current, batch)
            current = current.copy()
            current.coef = current.coef * sign
        elif t is Sum:
            total = _materialize(current, batch, n_cols, vector, initial)
            for _ in range(op.count):
                other = stack.pop()
                total = total + _materialize(other, batch, n_cols, vector, initial)
            current = _State("full", 1.0, total)
        else:
            raise TypeError(f"Unknown op {op}.")

    return _materialize(current, batch, n_cols, vector, initial)


def compute_fields(
    batch: ElementBatch,
    field_keys: Sequence,
    form_spec: ElementFormSpecification | None = None,
    dofs=None,
    static_fields: dict | None = None,
) -> dict:
    """Resolve interior-product fields to ``[E, nq, 2]`` tensors.

    Callable fields must be supplied pre-evaluated through ``static_fields``
    (host-evaluated once with NumPy; see :func:`evaluate_static_fields`).
    String fields name unknown 1-forms and are reconstructed from ``dofs``
    (the nonlinear advection coupling).
    """
    out: dict = {}
    for key in field_keys:
        if isinstance(key, str):
            if form_spec is None or dofs is None:
                raise ValueError(
                    f"Field {key!r} is an unknown form: it needs the form"
                    " specification and the DoFs."
                )
            idx = form_spec.index((key, UnknownFormOrder.FORM_ORDER_1))
            p1, p2 = batch.orders
            off = form_spec.form_offset(idx, p1, p2)
            size = form_spec.form_size(idx, p1, p2)
            out[key] = batch.reconstruct_one_form(dofs[:, off : off + size])
        else:
            if static_fields is None or key not in static_fields:
                raise KeyError(
                    f"Static field {getattr(key, '__name__', key)} was not "
                    "pre-evaluated; call evaluate_static_fields first."
                )
            out[key] = static_fields[key]
    return out


def evaluate_static_fields(batch: ElementBatch, field_keys: Sequence) -> dict:
    """Host-evaluate callable fields at the quadrature points (NumPy).

    User callables are arbitrary NumPy code, so they run on the host over the
    whole batch at once and the results move to the batch's device.
    """
    callables = [k for k in field_keys if not isinstance(k, str)]
    if not callables:
        return {}
    corners = batch.corners_np
    tb = batch.tb
    xi = np.broadcast_to(tb.nodes_xi[None, :], (tb.nodes_eta.size, tb.nodes_xi.size))
    eta = np.broadcast_to(tb.nodes_eta[:, None], xi.shape)
    shapes = np.stack(
        [
            (1 - xi) * (1 - eta),
            (1 + xi) * (1 - eta),
            (1 + xi) * (1 + eta),
            (1 - xi) * (1 + eta),
        ]
    ).reshape(4, -1) / 4
    x = corners[:, :, 0] @ shapes
    y = corners[:, :, 1] @ shapes
    out = {}
    for fn in callables:
        vals = np.asarray(fn(x, y), np.float64)
        if vals.shape != x.shape + (2,):
            raise ValueError(
                f"Vector field {getattr(fn, '__name__', fn)} must return shape"
                f" {(x.shape + (2,))}, got {vals.shape}."
            )
        out[fn] = to_device(vals, batch.device, torch.float64)
    return out


def _pure_mass(ops: Sequence) -> tuple[UnknownFormOrder, float] | None:
    """``(order, k)`` of a block that is ``k`` times one mass matrix, else None."""
    masses = [op for op in ops if type(op) is MassMat]
    if len(masses) != 1 or masses[0].inv:
        return None
    k = 1.0
    for op in ops:
        if type(op) is Scale:
            k *= op.k
        elif type(op) is not MassMat:
            return None
    return masses[0].order, k


def compute_element_matrices(
    form_spec: ElementFormSpecification,
    blocks: SystemBlocks,
    batch: ElementBatch,
    dofs=None,
    static_fields: dict | None = None,
) -> torch.Tensor:
    """Full element system matrices ``[E, N, N]`` for the batch.

    The batched analogue of the reference ``compute_element_matrix``
    (element_system.c:13-212).  A block that is a constant times one mass
    matrix reads the batch's memoized mass (the M1 kernel for a 1-form on
    CUDA tensors), which the residuals share; other blocks linear in the
    metric go through the fused pair-table plan when
    ``config.fused_assembly`` is on, the rest through the stack machine.
    """
    p1, p2 = batch.orders
    sizes = form_spec.form_sizes(p1, p2)
    from mfv2d_torch.compiler import collect_fields
    from mfv2d_torch.config import config as _cfg
    from mfv2d_torch.ops.fused_assembly import evaluate_block_fused, try_plan

    needed = collect_fields(blocks)
    fields = compute_fields(batch, needed, form_spec, dofs, static_fields)

    use_fused = _cfg.fused_assembly
    det = batch.jac.det
    k_cache: dict = {}
    rows = []
    for i, row in enumerate(blocks):
        cols = []
        for j, block in enumerate(row):
            if block is None:
                cols.append(det.new_zeros((batch.n_elements, sizes[i], sizes[j])))
                continue
            mass = _pure_mass(block)
            if mass is not None:
                cols.append(mass[1] * batch.mass(mass[0], False))
                continue
            plan = try_plan(block, batch) if use_fused else None
            if plan is not None:
                cols.append(evaluate_block_fused(plan, batch, fields, k_cache))
            else:
                cols.append(evaluate_block(block, batch, fields, sizes[j]))
        rows.append(torch.cat(cols, dim=2))
    return torch.cat(rows, dim=1)


def compute_element_vectors(
    form_spec: ElementFormSpecification,
    blocks: SystemBlocks,
    batch: ElementBatch,
    dofs: torch.Tensor,
    static_fields: dict | None = None,
) -> torch.Tensor:
    """Element residual/forcing vectors ``[E, N]``: blocks applied to DoFs.

    Batched analogue of ``compute_element_vector`` (element_system.c:245-440):
    each block is seeded with the current solution slice of its column form.
    """
    p1, p2 = batch.orders
    sizes = form_spec.form_sizes(p1, p2)
    offsets = form_spec.form_offsets(p1, p2)
    from mfv2d_torch.compiler import collect_fields

    needed = collect_fields(blocks)
    fields = compute_fields(batch, needed, form_spec, dofs, static_fields)

    rows = []
    for i, row in enumerate(blocks):
        acc = None
        for j, block in enumerate(row):
            if block is None:
                continue
            seed = dofs[:, offsets[j] : offsets[j + 1]]
            val = evaluate_block(block, batch, fields, sizes[j], initial=seed)
            acc = val if acc is None else acc + val
        if acc is None:
            acc = dofs.new_zeros((batch.n_elements, sizes[i]))
        rows.append(acc)
    return torch.cat(rows, dim=1)


def apply_mass(
    form_spec: ElementFormSpecification,
    batch: ElementBatch,
    dofs: torch.Tensor,
    *,
    inverse: bool,
) -> torch.Tensor:
    """Per-form (inverse) mass application over the full element vector.

    ``dofs`` is ``[E, total_size]``; applies M or M^-1 of each form's order
    to its slice (primal<->dual conversion, solve_system.py:274-351).
    """
    parts = []
    off = 0
    for _, order in form_spec:
        n = order.full_unknown_count(*batch.orders)
        v = dofs[:, off : off + n, None]
        off += n
        m = batch.mass(order, False)
        parts.append((_mass_solve(m, v) if inverse else torch.matmul(m, v))[..., 0])
    return torch.cat(parts, dim=1)


def compute_element_projector(
    form_spec: ElementFormSpecification,
    batch_in: ElementBatch,
    batch_out: ElementBatch,
) -> list[torch.Tensor]:
    """Per-form L2 projection matrices from ``batch_in`` to ``batch_out``.

    ``P = M_out^{-1} @ M_cross`` with cross-space mass matrices evaluated on
    the shared integration grid (element_system.c:480-560).  Returns one
    ``[E, n_out, n_in]`` tensor per form.  ``M_out`` is ``batch_out``'s
    memoized mass, so a 1-form goes through the M1 kernel on CUDA tensors.
    """
    if batch_in.basis.integration_orders != batch_out.basis.integration_orders:
        raise ValueError("Input and output integration rules must match.")
    out: list[torch.Tensor] = []
    jac = batch_in.jac
    for _, order in form_spec:
        if order == UnknownFormOrder.FORM_ORDER_0:
            cross = mass_node_double(batch_in.tb, batch_out.tb, jac)
        elif order == UnknownFormOrder.FORM_ORDER_1:
            cross = mass_edge_double(batch_in.tb, batch_out.tb, jac)
        elif order == UnknownFormOrder.FORM_ORDER_2:
            cross = mass_surf_double(batch_in.tb, batch_out.tb, jac)
        else:
            raise ValueError(f"Invalid form order {order}.")
        out.append(_mass_solve(batch_out.mass(order, False), cross))
    return out


# Elements per projector build: the build materializes quadrature
# intermediates per element, so larger batches are built in chunks.
PROJECTOR_CHUNK = 512


def element_projector(
    form_spec: ElementFormSpecification,
    batch_in: ElementBatch,
    batch_out: ElementBatch,
) -> list[torch.Tensor]:
    """:func:`compute_element_projector` in chunks of ``PROJECTOR_CHUNK``
    elements, concatenated.

    The VMS Green's operator on hp meshes and the VMS error estimator use
    it (:mod:`mfv2d_torch.solver.vms`, :mod:`mfv2d_torch.refinement`).
    """
    if batch_in.basis.integration_orders != batch_out.basis.integration_orders:
        raise ValueError("Input and output integration rules must match.")
    e = batch_in.n_elements
    if e <= PROJECTOR_CHUNK:
        return compute_element_projector(form_spec, batch_in, batch_out)
    chunks = []
    for lo in range(0, e, PROJECTOR_CHUNK):
        corners = batch_in.corners_np[lo : lo + PROJECTOR_CHUNK]
        chunks.append(
            compute_element_projector(
                form_spec,
                ElementBatch(batch_in.basis, corners, batch_in.device),
                ElementBatch(batch_out.basis, corners, batch_out.device),
            )
        )
    return [torch.cat(parts, dim=0) for parts in zip(*chunks)]


def _apply_projectors(
    form_spec: ElementFormSpecification,
    projectors: Sequence[torch.Tensor],
    orders_in: tuple[int, int],
    dofs: torch.Tensor,
) -> torch.Tensor:
    offsets = form_spec.form_offsets(*orders_in)
    return torch.cat(
        [
            torch.matmul(p, dofs[:, offsets[i] : offsets[i + 1], None])[..., 0]
            for i, p in enumerate(projectors)
        ],
        dim=1,
    )


def project_between(
    form_spec: ElementFormSpecification,
    batch_in: ElementBatch,
    batch_out: ElementBatch,
    dofs,
) -> torch.Tensor:
    """L2-project full element DoF vectors ``[E, n_in]`` from ``batch_in``'s
    orders to ``batch_out``'s: ``[E, n_out]`` on the batches' device."""
    dofs = to_device(dofs, batch_in.device, torch.float64)
    projectors = compute_element_projector(form_spec, batch_in, batch_out)
    return _apply_projectors(form_spec, projectors, batch_in.orders, dofs)


def projection_roundtrip_error(
    form_spec: ElementFormSpecification,
    batch: ElementBatch,
    batch_lower: ElementBatch,
    dofs,
) -> torch.Tensor:
    """``dofs - P_up(P_down(dofs))``: the order-reduction error DoFs."""
    dofs = to_device(dofs, batch.device, torch.float64)
    down = project_between(form_spec, batch, batch_lower, dofs)
    back = compute_element_projector(form_spec, batch_lower, batch)
    return dofs - _apply_projectors(form_spec, back, batch_lower.orders, down)


@lru_cache(maxsize=64)
def _reference_inclusion_cached(spec_items, orders_in, orders_out, device):
    from mfv2d_torch.ops.basis import FemCache

    # Exact rule for the finer mass matrix: GLL with q points integrates
    # degree 2q-3, the fine mass integrand is degree 2*p_f.
    q1 = orders_out[0] + 3
    q2 = orders_out[1] + 3
    cache = FemCache(0)
    ref_corners = np.array([[[-1.0, -1.0], [1.0, -1.0], [1.0, 1.0], [-1.0, 1.0]]])
    batch_in = ElementBatch(cache.get_basis2d(*orders_in, q1, q2), ref_corners, device)
    batch_out = ElementBatch(cache.get_basis2d(*orders_out, q1, q2), ref_corners, device)
    form_spec = ElementFormSpecification(*spec_items)
    projs = compute_element_projector(form_spec, batch_in, batch_out)
    off_in = form_spec.form_offsets(*orders_in)
    off_out = form_spec.form_offsets(*orders_out)
    full = np.zeros((form_spec.total_size(*orders_out), form_spec.total_size(*orders_in)))
    for i, p in enumerate(projs):
        full[off_out[i] : off_out[i + 1], off_in[i] : off_in[i + 1]] = to_host(p[0])
    return full


def reference_inclusion_matrix(
    form_spec: ElementFormSpecification,
    orders_in: tuple[int, int],
    orders_out: tuple[int, int],
    device="cuda",
) -> np.ndarray:
    """Shared coarse-to-fine inclusion matrix ``[n_out, n_in]`` (NumPy f64).

    For nested spaces on the same element (``orders_out >= orders_in``
    componentwise), every coarse basis function is exactly representable in
    the fine basis in reference space, and the bilinear map carries that
    identity to any physical element: the L2 projector ``M_f^{-1} M_cross``
    is the same matrix ``C`` for every element.  Computed once per (spec,
    orders) on the reference square, on ``device``, with a quadrature rule
    exact for the fine mass matrix.

    The VMS Green's operator uses it on meshes of one order
    (:mod:`mfv2d_torch.solver.vms`).
    """
    if orders_out[0] < orders_in[0] or orders_out[1] < orders_in[1]:
        raise ValueError(
            "Inclusion requires nested spaces: output orders must be >= "
            f"input orders ({orders_out} < {orders_in})."
        )
    return _reference_inclusion_cached(
        tuple((n, int(o)) for n, o in form_spec),
        tuple(int(o) for o in orders_in),
        tuple(int(o) for o in orders_out),
        str(check_device(device)),
    ).copy()
