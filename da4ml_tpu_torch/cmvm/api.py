"""Solver front door: two-stage solve with latency budget + decompose_dc sweep.

``solve`` tries every decomposition depth dc ∈ [-1, min(hard_dc, ceil(log2
n_in))] and keeps the cheapest result; ``n_workers`` spreads that sweep over
host worker processes.

Counterpart of ``da4ml_tpu/cmvm/api.py`` (``_solve_dispatch_impl``, here
``_solve_dispatch``):

- ``backend='cpu'`` runs the Python host loop below;
- ``backend='cpp'`` runs the native C++ solver (``native.solve_native``,
  decision-identical with the host loop; ``n_workers`` is its OpenMP thread
  count, OpenMP's own when <= 0);
- ``backend='auto'`` resolves to ``'cpp'`` when the native solver builds and
  loads (``native.has_solver()``), else to ``'cpu'``, as the reference's does;
- ``backend='torch'`` runs the device search ``torch_search.solve_torch``
  on ``device`` (the card when None; ``'cpu'`` runs its plain torch loop),
  ``quality=`` (the beam search) included.

On the host backends a ``quality`` other than ``'fast'`` degrades as in the
reference: the spec's heuristic portfolio joins the method candidates, the
beam and restart lanes are dropped, and one warning per backend says so.
"""

from __future__ import annotations

import os
import time
import warnings
from concurrent.futures import ProcessPoolExecutor
from math import ceil, inf, log2

import numpy as np
from numpy.typing import NDArray

from .. import telemetry
from ..ir.comb import CombLogic, Pipeline
from ..ir.types import QInterval
from .core import solve_single, to_solution
from .decompose import kernel_decompose
from .state import create_state

BACKENDS = ('cpu', 'cpp', 'auto', 'torch')

#: the keys of the warnings already given (the reference's ``warn_once``)
_warned: set[str] = set()


def warn_once(key: str, message: str) -> None:
    """``warnings.warn(message)`` the first time ``key`` is seen in this
    process, and never again."""
    if key not in _warned:
        _warned.add(key)
        warnings.warn(message, stacklevel=4)


def minimal_latency(
    kernel: NDArray,
    qintervals: list[QInterval],
    latencies: list[float],
    carry_size: int,
    adder_size: int,
) -> float:
    """Latency of the plain balanced adder tree (no CSE)."""
    state = create_state(kernel, qintervals, latencies, no_stat_init=True)
    sol = to_solution(state, adder_size, carry_size)
    max_lat = 0.0
    for idx in sol.out_idxs:
        lat = sol.ops[idx].latency if idx >= 0 else 0.0
        max_lat = max(max_lat, lat)
    return max_lat


def stage_feed(sol: CombLogic) -> tuple[list[QInterval], list[float]]:
    """Inter-stage intervals/latencies: the *output* qints (out_shift/neg
    applied) so downstream DAIS execution stays exact. Zero outputs
    (out_idx == -1) feed a zero interval."""
    return sol.out_qint, sol.out_latency


def _default_qint_lat(kernel, qintervals, latencies):
    n_in = kernel.shape[0]
    if not qintervals:
        qintervals = [QInterval(-128.0, 127.0, 1.0)] * n_in
    if not latencies:
        latencies = [0.0] * n_in
    return qintervals, latencies


def _solve(
    kernel: NDArray,
    method0: str,
    method1: str,
    hard_dc: int,
    decompose_dc: int,
    qintervals: list[QInterval] | None = None,
    latencies: list[float] | None = None,
    adder_size: int = -1,
    carry_size: int = -1,
) -> Pipeline:
    """One two-stage solve at a fixed decompose depth."""
    kernel = np.asarray(kernel, dtype=np.float64)
    n_in = kernel.shape[0]

    if method1 == 'auto':
        if hard_dc >= 6 or method0.endswith('dc'):
            method1 = method0
        else:
            method1 = method0 + '-dc'
    if hard_dc == 0 and not method0.endswith('dc'):
        method0 = method0 + '-dc'

    qintervals, latencies = _default_qint_lat(kernel, qintervals, latencies)

    min_lat = inf
    if hard_dc >= 0:
        min_lat = minimal_latency(kernel, qintervals, latencies, carry_size, adder_size)
    latency_allowed = hard_dc + min_lat

    log2_n = int(ceil(log2(n_in)))
    if decompose_dc == -2:
        decompose_dc = min(hard_dc, log2_n)
    else:
        decompose_dc = min(hard_dc, decompose_dc, log2_n)

    while True:
        if decompose_dc < 0 and hard_dc >= 0:
            if method0 != 'dummy':
                method0 = method1 = 'wmc-dc'
            else:
                method0 = method1 = 'dummy'

        mat0, mat1 = kernel_decompose(kernel, decompose_dc)
        sol0 = solve_single(mat0, method0, qintervals, latencies, adder_size, carry_size)

        qintervals0, latencies0 = stage_feed(sol0)
        max_lat0 = max(latencies0, default=0.0)

        if max_lat0 > latency_allowed:
            if not (method0 == 'wmc-dc' and method1 == 'wmc-dc') or decompose_dc >= 0:
                decompose_dc -= 1
                continue

        sol1 = solve_single(mat1, method1, qintervals0, latencies0, adder_size, carry_size)

        max_lat1 = max((sol1.ops[idx].latency if idx >= 0 else 0.0 for idx in sol1.out_idxs), default=0.0)
        if max_lat1 > latency_allowed:
            if not (method0 == 'wmc-dc' and method1 == 'wmc-dc') or decompose_dc >= 0:
                decompose_dc -= 1
                continue
        break

    return Pipeline(stages=(sol0, sol1))


def _solve_task(args) -> Pipeline:
    # args[4] is the decompose depth of this sweep candidate (see tasks below)
    with telemetry.span('cmvm.solve_dc', dc=args[4], method0=args[1]):
        return _solve(*args)


def _pipeline_cost(p: Pipeline) -> float:
    return float(sum(op.cost for sol in p.stages for op in sol.ops))


def solve(
    kernel: NDArray,
    method0: str = 'wmc',
    method1: str = 'auto',
    hard_dc: int = -1,
    decompose_dc: int = -2,
    qintervals: list[QInterval] | None = None,
    latencies: list[float] | None = None,
    adder_size: int = -1,
    carry_size: int = -1,
    search_all_decompose_dc: bool = True,
    backend: str = 'cpu',
    n_workers: int = 0,
    method0_candidates: list[str] | None = None,
    n_restarts: int = 1,
    mesh=None,
    *,
    quality='fast',
    device=None,
) -> Pipeline:
    """Full CMVM solve with an optional sweep over all decompose depths.

    ``backend='torch'`` runs the device search on ``device`` (the card when
    None); ``method0_candidates``, ``n_restarts`` and ``quality`` are its
    options (``solve_torch``). The host backends take ``method0_candidates``
    as a sequential sweep (the cheapest solution wins) and run no restarts;
    a ``quality`` spec adds its portfolio to that sweep and warns once per
    backend that its beam and restarts were dropped.

    ``n_workers > 1`` solves the host sweep's candidates in that many worker
    processes (spawned: the caller may hold threads, and fork is unsafe
    then); the result is the same as the sequential sweep's. On ``'cpp'`` it
    is the native solver's thread count. ``'auto'`` is ``'cpp'`` when the
    native library builds, else ``'cpu'``.

    The parameters bind positionally as the reference's do
    (``da4ml_tpu/cmvm/api.py``): ``mesh`` is the fifteenth, and must be None
    (the multi-device search is not ported); ``quality`` and the port's
    ``device`` are keyword-only.

    Telemetry: each call is one ``cmvm.solve`` span and one
    ``solve.duration_s`` / ``solve.adders`` sample when telemetry is enabled
    (``DA4ML_TRACE`` or ``telemetry.enable()``).
    """
    if mesh is not None:
        raise NotImplementedError('mesh: the multi-device search is not ported')
    kernel = np.asarray(kernel, dtype=np.float64)
    if kernel.ndim != 2 or kernel.shape[0] == 0 or kernel.shape[1] == 0:
        raise ValueError(f'kernel must be a non-empty 2D matrix, got shape {kernel.shape}')
    _metrics = telemetry.metrics_on()
    _t0 = time.perf_counter() if _metrics else 0.0
    with telemetry.span('cmvm.solve', backend=backend, shape=f'{kernel.shape[0]}x{kernel.shape[1]}') as _sp:
        result = _post_solve_verify(
            _solve_dispatch(
                kernel, method0, method1, hard_dc, decompose_dc, qintervals, latencies, adder_size, carry_size,
                search_all_decompose_dc, backend, n_workers, method0_candidates, n_restarts, quality, device,
            )
        )  # fmt: skip
        if _metrics:
            telemetry.counter('solve.calls').inc()
            telemetry.histogram('solve.duration_s').observe(time.perf_counter() - _t0)
            # adder counts are 1..1e6-scale: the count ladder, not seconds
            telemetry.histogram('solve.adders', telemetry.COUNT_BUCKETS).observe(float(result.cost))
        if _sp:
            _sp.set(cost=float(result.cost))
        return result


def _post_solve_verify(result: Pipeline) -> Pipeline:
    """Opt-in ``DA4ML_VERIFY=1`` hook: verify every program ``solve`` emits."""
    from ..analysis import post_solve_verify_enabled, verify_or_raise

    if post_solve_verify_enabled():
        verify_or_raise(result, context='post-solve verify (DA4ML_VERIFY=1)')
    return result


def _solve_dispatch(
    kernel, method0, method1, hard_dc, decompose_dc, qintervals, latencies, adder_size, carry_size,
    search_all_decompose_dc, backend, n_workers, method0_candidates, n_restarts, quality, device,
) -> Pipeline:  # fmt: skip
    """``solve`` on the chosen backend, before the post-solve hook; ``kernel``
    is the float64 matrix that ``solve`` checked."""
    with telemetry.span('cmvm.dispatch', backend=backend, shape='x'.join(map(str, kernel.shape))):
        if backend not in BACKENDS:
            raise ValueError(f'backend {backend!r} is not ported to da4ml_tpu_torch (ported: {BACKENDS})')
        qintervals, latencies = _default_qint_lat(kernel, qintervals, latencies)

        if backend == 'auto':  # the fastest host path, as in the reference
            from ..native import has_solver

            backend = 'cpp' if has_solver() else 'cpu'

        if backend == 'torch':
            from .torch_search import solve_torch

            return solve_torch(
                kernel,
                method0=method0,
                method1=method1,
                hard_dc=hard_dc,
                decompose_dc=decompose_dc,
                qintervals=qintervals,
                latencies=latencies,
                adder_size=adder_size,
                carry_size=carry_size,
                search_all_decompose_dc=search_all_decompose_dc,
                method0_candidates=method0_candidates,
                n_restarts=n_restarts,
                quality=quality,
                device=device,
            )
        if quality not in (None, 'fast'):
            from .search.spec import resolve_quality

            spec = resolve_quality(quality)
            if not spec.is_fast:
                warn_once(f'cmvm.quality.{backend}', f'quality beam search runs on the torch backend only; degrading to a '
                          f'portfolio sweep on backend {backend!r} (beam/restart lanes dropped)')  # fmt: skip
                method0_candidates = list(dict.fromkeys([*(method0_candidates or [method0]), *spec.portfolio]))
            quality = None
        if n_restarts and int(n_restarts) > 1:  # the restart axis is a device-lane feature, as in the reference
            warnings.warn(f'n_restarts={n_restarts} requires the torch backend; restart lanes are not run on backend '
                          f'{backend!r}', stacklevel=3)  # fmt: skip
        if method0_candidates:
            sols = [
                _solve_dispatch(kernel, mc, method1, hard_dc, decompose_dc, qintervals, latencies, adder_size, carry_size,
                                search_all_decompose_dc, backend, n_workers, None, 1, quality, device)
                for mc in dict.fromkeys(method0_candidates)
            ]  # fmt: skip
            return min(sols, key=lambda s: s.cost)

        if backend == 'cpp':
            from ..native import solve_native

            return solve_native(
                kernel,
                method0=method0,
                method1=method1,
                hard_dc=hard_dc,
                decompose_dc=decompose_dc,
                qintervals=qintervals,
                latencies=latencies,
                adder_size=adder_size,
                carry_size=carry_size,
                search_all_decompose_dc=search_all_decompose_dc,
                n_threads=n_workers,
            )

        if not search_all_decompose_dc:
            return _solve(kernel, method0, method1, hard_dc, decompose_dc, qintervals, latencies, adder_size, carry_size)

        _hard_dc = hard_dc if hard_dc >= 0 else 10**9
        n_in = kernel.shape[0]
        max_dc = min(_hard_dc, int(ceil(log2(n_in))))
        try_dcs = list(range(-1, max_dc + 1))

        tasks = [(kernel, method0, method1, _hard_dc, dc, qintervals, latencies, adder_size, carry_size) for dc in try_dcs]

        if n_workers <= 1 or len(try_dcs) == 1:
            candidates = [_solve_task(t) for t in tasks]
        else:
            import multiprocessing as mp

            ctx = mp.get_context('spawn')
            workers = min(n_workers, len(try_dcs), os.cpu_count() or 1)
            with ProcessPoolExecutor(max_workers=workers, mp_context=ctx) as ex:
                candidates = list(ex.map(_solve_task, tasks))

        costs = [_pipeline_cost(c) for c in candidates]
        return candidates[int(np.argmin(costs))]
