"""Two-operand einsum over symbolic arrays.

The subscript expression is lowered to a *batched-matmul normal form*:
every axis of each operand is classified as batch (shared, kept), contracted
(shared, summed), free (exclusive, kept) or collapsed (exclusive, summed),
the operands are transposed/reshaped to ``[B, M, K]`` and ``[B, K, N]``, and
the contraction runs as B independent ``[M, K] @ [K, N]`` matmuls — so any
constant-side operand hits the CMVM matmul path of
:class:`~da4ml_tpu_torch.trace.fixed_variable_array.FixedVariableArray`.

Counterpart of ``da4ml_tpu/trace/ops/einsum_utils.py``; the traces are the same.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from math import prod

import numpy as np

_TERM_RE = re.compile(r'^[a-zA-Z]*(\.\.\.)?[a-zA-Z]*$')
_LETTERS = 'abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ'


@dataclass(frozen=True)
class EinsumPlan:
    """Lowering of one einsum expression at fixed operand shapes."""

    collapse0: tuple[int, ...]  # axes of operand 0 summed away up front
    collapse1: tuple[int, ...]
    perm0: tuple[int, ...]  # post-collapse transpose to (batch, free0, contracted)
    perm1: tuple[int, ...]  # post-collapse transpose to (batch, contracted, free1)
    b: int  # prod of batch dims
    m: int  # prod of free0 dims
    k: int  # prod of contracted dims
    n: int  # prod of free1 dims
    stacked_shape: tuple[int, ...]  # batch + free0 + free1 dims
    out_perm: tuple[int, ...]  # stacked order -> requested output order


def _split_terms(expr: str) -> tuple[str, str, str]:
    try:
        lhs, rhs = expr.split('->')
        t0, t1 = lhs.split(',')
    except ValueError:
        raise ValueError(f'einsum string {expr!r} must have the form "A,B->C"') from None
    return t0.strip(), t1.strip(), rhs.strip()


def _expand(term: str, ndim: int, ell: str, what: str, expr: str) -> list[str]:
    """Expand '...' in one operand term against its actual rank."""
    if not _TERM_RE.match(term):
        raise ValueError(f"einsum string {expr!r} is invalid: subscripts must be [a-zA-Z] and '...'")
    if '...' in term:
        named = term.replace('...', '')
        n_ell = ndim - len(named)
        if n_ell < 0:
            raise ValueError(f'{what} requires at least {len(named)} dims, got {ndim}')
        labels = list(term.replace('...', ell[len(ell) - n_ell :]))
    else:
        labels = list(term)
        if len(labels) != ndim:
            raise ValueError(f'{what} requires {len(labels)} dims, got {ndim}')
    seen: set[str] = set()
    for lab in labels:
        if lab in seen:
            orig = lab if lab in term else '...'
            raise ValueError(f"einsum string {expr!r} is invalid: {what} includes '{orig}' multiple times")
        seen.add(lab)
    return labels


def plan_einsum(expr: str, shape0: tuple[int, ...], shape1: tuple[int, ...]) -> EinsumPlan:
    """Validate ``expr`` against the operand shapes and build the lowering plan."""
    t0, t1, t_out = _split_terms(expr)

    # ellipsis labels come from letters the expression itself never uses
    used = set(t0) | set(t1) | set(t_out)
    ell = ''.join(c for c in _LETTERS if c not in used)

    has_ell = ('...' in t0, '...' in t1, '...' in t_out)
    if any(has_ell[:2]) and not has_ell[2]:
        raise ValueError(f'einsum string {expr!r} is invalid: inputs broadcast but output does not')
    if has_ell[2] and not any(has_ell[:2]):
        raise ValueError(f'einsum string {expr!r} is invalid: output broadcasts but inputs do not')

    lab0 = _expand(t0, len(shape0), ell, 'input0', expr)
    lab1 = _expand(t1, len(shape1), ell, 'input1', expr)
    if has_ell[0] and has_ell[1]:
        n0 = len(lab0) - len(t0.replace('...', ''))
        n1 = len(lab1) - len(t1.replace('...', ''))
        if n0 != n1:
            raise ValueError(f"einsum string {expr!r}: '...' expands to {n0} and {n1} axes in the two inputs")
    n_ell_out = max(len(lab0) - len(t0.replace('...', '')), len(lab1) - len(t1.replace('...', '')), 0)
    lab_out = list(t_out.replace('...', ell[len(ell) - n_ell_out :] if has_ell[2] else ''))
    seen: set[str] = set()
    for lab in lab_out:
        if lab in seen:
            orig = lab if lab in t_out else '...'
            raise ValueError(f"einsum string {expr!r} is invalid: output includes '{orig}' multiple times")
        seen.add(lab)

    dims: dict[str, int] = {}
    for labels, shape in ((lab0, shape0), (lab1, shape1)):
        for lab, d in zip(labels, shape):
            if dims.setdefault(lab, d) != d:
                raise ValueError(f"Dimension mismatch for subscript '{lab}': {dims[lab]} vs {d}")
    if unknown := set(lab_out) - set(lab0) - set(lab1):
        raise ValueError(f'einsum string {expr!r} is invalid: output subscripts {unknown} not found in inputs')

    s0, s1, s_out = set(lab0), set(lab1), set(lab_out)
    batch = [lab for lab in lab0 if lab in s1 and lab in s_out]
    contracted = [lab for lab in lab0 if lab in s1 and lab not in s_out]
    free0 = [lab for lab in lab0 if lab not in s1 and lab in s_out]
    free1 = [lab for lab in lab1 if lab not in s0 and lab in s_out]
    collapse0 = tuple(a for a, lab in enumerate(lab0) if lab not in s1 and lab not in s_out)
    collapse1 = tuple(a for a, lab in enumerate(lab1) if lab not in s0 and lab not in s_out)

    kept0 = [lab for a, lab in enumerate(lab0) if a not in collapse0]
    kept1 = [lab for a, lab in enumerate(lab1) if a not in collapse1]
    perm0 = tuple(kept0.index(lab) for lab in batch + free0 + contracted)
    perm1 = tuple(kept1.index(lab) for lab in batch + contracted + free1)

    stacked = batch + free0 + free1
    return EinsumPlan(
        collapse0=collapse0,
        collapse1=collapse1,
        perm0=perm0,
        perm1=perm1,
        b=prod(dims[lab] for lab in batch),
        m=prod(dims[lab] for lab in free0),
        k=prod(dims[lab] for lab in contracted),
        n=prod(dims[lab] for lab in free1),
        stacked_shape=tuple(dims[lab] for lab in stacked),
        out_perm=tuple(stacked.index(lab) for lab in lab_out),
    )


def _run_plan(plan: EinsumPlan, x0, x1) -> np.ndarray:
    """Execute the plan: B independent [M,K] @ [K,N] matmuls."""
    from ..fixed_variable_array import FixedVariableArray

    def _collapse(x, axes):
        if not axes:
            return x
        y = np.sum(x, axis=axes)
        if isinstance(x, FixedVariableArray) and not isinstance(y, FixedVariableArray):
            # a full collapse unwraps to a scalar FixedVariable; re-wrap as 0-d
            y = FixedVariableArray(np.array(y, dtype=object), x.solver_options, hwconf=x.hwconf)
        return y

    x0 = _collapse(x0, plan.collapse0)
    x1 = _collapse(x1, plan.collapse1)
    x0 = x0.transpose(plan.perm0).reshape((plan.b, plan.m, plan.k))
    x1 = x1.transpose(plan.perm1).reshape((plan.b, plan.k, plan.n))

    symbolic = isinstance(x0, FixedVariableArray) or isinstance(x1, FixedVariableArray)
    out = np.empty((plan.b, plan.m, plan.n), dtype=object if symbolic else np.float64)

    # variable @ constant batches: all B blocks solve as one device batch on
    # the torch backend (cmvm_multi); collapsed blocks keep the numeric path
    x0_sym, x1_sym = isinstance(x0, FixedVariableArray), isinstance(x1, FixedVariableArray)
    if (
        symbolic
        and (x0_sym != x1_sym)
        and plan.b > 1
        # the const side must be plain numbers (an object ndarray of
        # FixedVariables takes the mmm path inside matmul instead)
        and np.asarray(x1 if x0_sym else x0).dtype != object
    ):
        from ..fixed_variable_array import cmvm_multi

        jobs, idxs = [], []
        for bi in range(plan.b):
            if x0_sym and not x0[bi].collapsed:
                jobs.append((np.asarray(x1[bi], dtype=np.float64), x0[bi]))
                idxs.append(bi)
            elif x1_sym and not x1[bi].collapsed:
                # const [M,K] @ var [K,N] == (var.T [N,K] @ const.T [K,M]).T
                jobs.append((np.asarray(x0[bi], dtype=np.float64).T, x1[bi].transpose((1, 0))))
                idxs.append(bi)
            else:
                block = x0[bi] @ x1[bi]
                out[bi] = block._vars if isinstance(block, FixedVariableArray) else block
        solver_options = (x0 if x0_sym else x1).solver_options
        for bi, rows in zip(idxs, cmvm_multi(jobs, solver_options)):
            block = np.stack(rows, axis=0)
            out[bi] = block if x0_sym else block.T
        return out.reshape(plan.stacked_shape).transpose(plan.out_perm)

    for bi in range(plan.b):
        block = x0[bi] @ x1[bi]
        out[bi] = block._vars if isinstance(block, FixedVariableArray) else block
    return out.reshape(plan.stacked_shape).transpose(plan.out_perm)


def einsum(fn: str, input0, input1):
    """Einsum over two operands; symbolic arrays route through the CMVM matmul."""
    from ..fixed_variable_array import FixedVariableArray

    plan = plan_einsum(fn, input0.shape, input1.shape)
    r = _run_plan(plan, input0, input1)
    for operand in (input0, input1):
        if isinstance(operand, FixedVariableArray):
            return FixedVariableArray(r, operand.solver_options)
    return r
