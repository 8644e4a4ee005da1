"""CMVM: multiplier-free constant matrix-vector multiply optimization
(host solver, and the device search ``solve_torch``)."""

from typing import TypedDict

try:  # typing.NotRequired is 3.11+; 3.10 ships it in typing_extensions
    from typing import NotRequired
except ImportError:  # pragma: no cover - version-dependent
    from typing_extensions import NotRequired

from .api import minimal_latency, solve
from .core import cmvm, solve_single, to_solution
from .csd import csd_decompose, int_arr_to_csd
from .decompose import kernel_decompose, prim_mst_dc


def __getattr__(name: str):
    # the device search imports torch; the host solver's spawned workers
    # import this package and should not pay for that
    if name in ('solve_torch', 'solve_torch_many'):
        from . import torch_search

        return getattr(torch_search, name)
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')


class solver_options_t(TypedDict):
    """Per-solve options merged over HWConfig defaults."""

    method0: NotRequired[str]
    method1: NotRequired[str]
    hard_dc: NotRequired[int]
    decompose_dc: NotRequired[int]
    adder_size: NotRequired[int]
    carry_size: NotRequired[int]
    search_all_decompose_dc: NotRequired[bool]
    backend: NotRequired[str]
    n_workers: NotRequired[int]
    method0_candidates: NotRequired[list[str]]
    n_restarts: NotRequired[int]
    device: NotRequired[object]


__all__ = [
    'solve',
    'solve_torch',
    'solve_torch_many',
    'minimal_latency',
    'cmvm',
    'solve_single',
    'to_solution',
    'csd_decompose',
    'int_arr_to_csd',
    'kernel_decompose',
    'prim_mst_dc',
    'solver_options_t',
]
