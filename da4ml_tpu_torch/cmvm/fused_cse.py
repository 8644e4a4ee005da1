"""K2 — the greedy CSE loop of the device search as one hand-written CUDA
kernel — wrapper, build and launch count.

``csrc/fused_cse.cu`` replaces ``da4ml_tpu/cmvm/fused_cse.py::
_build_pallas_loop`` (the TPU's Pallas kernel behind ``build_fused_runner``).
It is built with ``nvcc`` for ``sm_90a`` into ``build/da4ml_tpu_torch/`` at
first use (``runtime.cuda_backend.compile_source``, with ``-fmad=false`` so
that no multiply-add is fused where the plain version rounds twice) and
loaded with ``ctypes``. One thread block runs one lane's whole loop; what
bounds it and what the design does about it is in the source's header note.

:func:`greedy_loop` is the entry the search calls: on a CUDA tensor it
launches the kernel on the current stream, or raises; on a CPU tensor it runs
the plain version ``torch_search.greedy_plain``. The module-level
``launches`` counts kernel launches since :func:`reset_counts`.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ..runtime import cuda_backend

SOURCE = Path(__file__).resolve().parents[1] / 'csrc' / 'fused_cse.cu'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3', '-fmad=false', '-shared', '-Xcompiler',
              '-fPIC', '-Xptxas', '-v')  # fmt: skip
#: score-cache depths the kernel is instantiated for (the search's K rule)
CACHE_DEPTHS = (8, 16)

#: kernel launches since the last ``reset_counts``
launches = 0
#: nvcc's diagnostics of the last build (ptxas register / spill report)
build_log = ''


def reset_counts() -> None:
    global launches
    launches = 0


def build() -> Path:
    """Compile ``csrc/fused_cse.cu`` for sm_90a (no-op when built)."""
    global build_log
    out, log = cuda_backend.compile_source(SOURCE, NVCC_FLAGS)
    if log:
        build_log = log
    return out


def _declare(lib) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.fused_cse_launch.restype = ci
    lib.fused_cse_launch.argtypes = [ci] + [vp] * 10 + [ci] * 8 + [vp]
    lib.fused_cse_error_string.restype = ctypes.c_char_p
    lib.fused_cse_error_string.argtypes = [ci]


def load():
    """The built kernel library, with its C signatures declared."""
    return cuda_backend.load_library(build, _declare)


def _check(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f'{what} failed: CUDA error {rc} ({lib.fused_cse_error_string(rc).decode()})')


def greedy_loop(E, qm, lat, tv, tc, cur, method, spec):
    """Run the greedy loop of every lane: ``(E, qmeta, lat, op records,
    cur)``. The state ``E, qm, lat, tv, tc, cur`` is updated in place and
    returned (see ``torch_search.greedy_plain`` for the layout). CPU tensors
    take the plain version; CUDA tensors launch K2."""
    if E.device.type == 'cpu':
        from .torch_search import greedy_plain

        return greedy_plain(E, qm, lat, tv, tc, cur, method, spec)
    if E.device.type != 'cuda':
        raise ValueError(f'the fused CSE kernel runs on CUDA tensors (CPU: its plain version), got {E.device}')
    return launch(E, qm, lat, tv, tc, cur, method, spec)


def launch(E, qm, lat, tv, tc, cur, method, spec):
    """Launch K2 on the current stream of the tensors' CUDA device; it
    updates ``E, qm, lat, tv, tc, cur`` in place and writes fresh records."""
    global launches
    N, P, O, B, K = E.shape[0], spec.P, spec.O, spec.B, spec.topk
    want = {
        'E': (E, torch.int8, (N, P, O, B)),
        'qm': (qm, torch.float32, (N, P, 3)),
        'lat': (lat, torch.float32, (N, P)),
        'tv': (tv, torch.float32, (N, 2, B, P, K)),
        'tc': (tc, torch.int32, (N, 2, B, P, K)),
        'cur': (cur, torch.int32, (N,)),
        'method': (method, torch.int32, (N,)),
    }
    for name, (t, dtype, shape) in want.items():
        if t.device != E.device or t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f'fused CSE kernel: {name} must be a contiguous {dtype} {shape} tensor on {E.device}, '
                f'got {t.dtype} {tuple(t.shape)} on {t.device}'
            )
    if K not in CACHE_DEPTHS:
        raise ValueError(f'fused CSE kernel: cache depth {K} is not one of {CACHE_DEPTHS}')
    if O * B > 32767:
        raise ValueError(f'fused CSE kernel: O*B = {O * B} digit planes exceed the kernel limit 32767')
    if N and bool((cur < P - spec.n_iters).any()):  # its records would run past rec
        raise ValueError(f'fused CSE kernel: a lane enters below slot P - n_iters = {P - spec.n_iters}: {cur.tolist()}')
    device = torch.device('cuda', E.device.index if E.device.index is not None else torch.cuda.current_device())
    rec = torch.zeros((N, spec.n_iters, 4), dtype=torch.int32, device=device)
    if N == 0:
        return E, qm, lat, rec, cur
    rows = torch.empty((N, 3, 2 * B, P), dtype=torch.float32, device=device)
    meta = torch.empty((N, 2, 3, P), dtype=torch.float32, device=device)
    lib = load()
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = lib.fused_cse_launch(
        device.index, E.data_ptr(), qm.data_ptr(), lat.data_ptr(), tv.data_ptr(), tc.data_ptr(),
        rec.data_ptr(), cur.data_ptr(), method.data_ptr(), rows.data_ptr(), meta.data_ptr(),
        N, P, O, B, K, spec.n_iters, spec.adder_size, spec.carry_size, stream,
    )  # fmt: skip
    _check(lib, rc, 'fused_cse launch')
    launches += 1
    return E, qm, lat, rec, cur
