"""K2 — a rung of the device search (score-cache build and the whole greedy
CSE loop) as one hand-written CUDA kernel — wrapper, geometry, build and
launch count.

``csrc/fused_cse.cu`` replaces ``da4ml_tpu/cmvm/fused_cse.py::
_build_pallas_loop`` (the TPU's Pallas kernel behind ``build_fused_runner``).
It is built with ``nvcc`` for ``sm_90a`` into ``build/da4ml_tpu_torch/`` at
first use (``runtime.cuda_backend.compile_source``, with ``-fmad=false`` so
that no multiply-add is fused where the plain version rounds twice) and
loaded with ``ctypes``. One thread-block cluster of ``C`` blocks runs one
lane: the lane's slots are split across the cluster, each block holding the
score-cache rows of its slots in its slice beside a replica of every slot's
digits (as bit planes) and metadata; the slice lives in shared memory when
it fits, else in a global-memory scratch with the same layout.
:func:`cluster_geometry` picks ``C``, the block size and the placement;
:func:`slice_layout` lays the slice out. What bounds the kernel and what the
design does about it is in the source's header note.

:func:`greedy_loop` is the entry the search calls: on a CUDA tensor it
launches the kernel on the current stream, or raises; on a CPU tensor it runs
the plain version ``torch_search.rung_plain`` (``init_cache``, then
``greedy_plain``). The module-level ``launches`` counts kernel launches since
:func:`reset_counts`.
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
#: the largest cluster the kernel takes (above 8 it is a non-portable size)
MAX_CLUSTER = 16
#: slots per block the cluster size aims at
SLOTS_PER_CTA = 16
#: shared memory the kernel's static arrays and the launch may need beside the slice
STATIC_SMEM = 1024
#: the regions of a block's slice, in ``Layout`` order of the source
SLICE_REGIONS = ('tv', 'tc', 'meta', 'planes', 'parts', 'S', 'cv', 'cc', 'nov')
#: phases of an iteration timed by a ``FUSED_CSE_PHASES`` build (:func:`phase_cycles`)
PHASES = ('cache build', 'argmax', 'cluster barrier 1', 'winner, commit, substitution', 'recount',
          'partial top-K and merge', 'cluster barrier 2', 'rebuild')

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
    vp, ci, pi = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    lib.fused_cse_launch.restype = ci
    lib.fused_cse_launch.argtypes = [ci] + [vp] * 8 + [ci] * 11 + [pi, vp]
    lib.fused_cse_active_clusters.restype = ci
    lib.fused_cse_active_clusters.argtypes = [ci] * 6 + [pi]
    lib.fused_cse_device_smem.restype = ci
    lib.fused_cse_device_smem.argtypes = [ci, pi, pi, pi]
    lib.fused_cse_error_string.restype = ctypes.c_char_p
    lib.fused_cse_error_string.argtypes = [ci]


def load():
    """The built kernel library, with its C signatures declared."""
    return cuda_backend.load_library(build, _declare)


def _check(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f'{what} failed: CUDA error {rc} ({lib.fused_cse_error_string(rc).decode()})')


def plane_words(O: int, B: int) -> int:
    """32-bit words of one bit plane of a digit row: 32 // B outputs a word."""
    return -(-O // (32 // B))


def slice_layout(P: int, O: int, B: int, K: int, C: int) -> dict[str, int]:
    """Byte offset of each region of a block's slice (``SLICE_REGIONS``,
    each 16-byte aligned) and the slice's size under ``'bytes'``."""
    PC, TB, W = P // C, 2 * B, plane_words(O, B)
    sizes = {
        'tv': 4 * K * TB * PC,  # score cache of the block's rows, rank-major
        'tc': 4 * K * TB * PC,
        'meta': 16 * P,  # every slot's lo, hi, step, latency (replicated)
        'planes': 4 * 2 * W * P,  # every slot's digit row as bit planes (replicated)
        'parts': 16 * C,  # the partial winners every block pushes
        'S': 4 * 2 * 3 * TB * PC,  # dirty-row and fresh-column scores
        'cv': 4 * 3 * TB * C * K,  # partial top-K lists of the dirty rows it merges
        'cc': 4 * 3 * TB * C * K,
        'nov': 4 * 2 * 3 * PC,  # n_overlap and |dlat| of the dirty rows
    }
    out, off = {}, 0
    for name in SLICE_REGIONS:
        out[name] = off
        off += (sizes[name] + 15) & ~15
    out['bytes'] = off
    return out


def cluster_geometry(P: int, O: int, B: int, K: int, smem: tuple[int, int, int]) -> tuple[int, int, str]:
    """(cluster size C, threads per block, placement 'shared' or 'global') of
    a rung class on a device with shared memory ``smem`` (per block with the
    opt-in, per SM, reserved per block).

    C is the smallest power of two from 2 to 16 that leaves at most
    ``SLOTS_PER_CTA`` slots per block (so 16 from P = 256 on). The block is
    the instantiation's largest, 512 threads (256 for K = 16, which needs
    more registers a thread), so that an iteration's partial top-K lists and
    merge run side by side on its warps. The slice goes to shared memory
    when it fits beside the kernel's static arrays, else to a global-memory
    scratch.
    """
    if P % 2:
        raise ValueError(f'fused CSE kernel: P = {P} slots cannot be split across a cluster')
    C = 2
    while C < MAX_CLUSTER and P % (2 * C) == 0 and P // C > SLOTS_PER_CTA:
        C *= 2
    threads = 512 if K <= 8 else 256
    need = slice_layout(P, O, B, K, C)['bytes'] + STATIC_SMEM
    return C, threads, 'shared' if need <= smem[0] else 'global'


_smem: dict[int, tuple[int, int, int]] = {}
_clusters: dict[tuple, int] = {}


def device_smem(device: torch.device) -> tuple[int, int, int]:
    """Shared memory of ``device`` in bytes: (per block, per SM, reserved per block)."""
    if device.index not in _smem:
        lib = load()
        vals = [ctypes.c_int(0) for _ in range(3)]
        _check(lib, lib.fused_cse_device_smem(device.index, *(ctypes.byref(v) for v in vals)), 'cudaDeviceGetAttribute')
        _smem[device.index] = tuple(v.value for v in vals)
    return _smem[device.index]


def active_clusters(device: torch.device, K: int, placement: str, C: int, threads: int, smem_bytes: int) -> int:
    """``cudaOccupancyMaxActiveClusters`` of one launch shape on ``device``."""
    key = (device.index, K, placement, C, threads, smem_bytes)
    if key not in _clusters:
        lib = load()
        n = ctypes.c_int(0)
        rc = lib.fused_cse_active_clusters(device.index, K, placement == 'global', C, threads, smem_bytes, ctypes.byref(n))
        _check(lib, rc, 'cudaOccupancyMaxActiveClusters')
        _clusters[key] = n.value
    return _clusters[key]


def greedy_loop(E, qm, lat, cur, method, spec):
    """One rung of every lane from its cache-less state: ``(E, qmeta, lat,
    op records, cur)``. The state ``E, qm, lat, cur`` is updated in place and
    returned (see ``torch_search.greedy_plain`` for the layout). CPU tensors
    take the plain version; CUDA tensors launch K2, which builds the score
    cache itself."""
    if E.device.type == 'cpu':
        from .torch_search import rung_plain

        return rung_plain(E, qm, lat, cur, method, spec)
    if E.device.type != 'cuda':
        raise ValueError(f'the fused CSE kernel runs on CUDA tensors (CPU: its plain version), got {E.device}')
    return launch(E, qm, lat, cur, method, spec)


def launch(E, qm, lat, cur, method, spec):
    """Launch K2 on the current stream of the tensors' CUDA device; it
    updates ``E, qm, lat, cur`` in place and writes fresh records."""
    global launches
    out = run(prepare(E, qm, lat, cur, method, spec))
    if E.shape[0]:
        launches += 1
    return out


def prepare(E, qm, lat, cur, method, spec) -> dict:
    """Check a launch's tensors (one device sync, for the lanes' entry
    slots), pick its geometry, allocate its records and scratch, and lay out
    the C launch's arguments for the current stream: what :func:`run`
    needs, so that a launch costs one foreign call of host time."""
    N, P, O, B, K = E.shape[0], spec.P, spec.O, spec.B, spec.topk
    want = {
        'E': (E, torch.int8, (N, P, O, B)),
        'qm': (qm, torch.float32, (N, P, 3)),
        'lat': (lat, torch.float32, (N, P)),
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
    if B > 32:
        raise ValueError(f'fused CSE kernel: B = {B} bit planes exceed the kernel limit 32')
    if N and bool((cur < P - spec.n_iters).any()):  # its records would run past rec
        raise ValueError(f'fused CSE kernel: a lane enters below slot P - n_iters = {P - spec.n_iters}: {cur.tolist()}')
    device = torch.device('cuda', E.device.index if E.device.index is not None else torch.cuda.current_device())
    rec = torch.zeros((N, spec.n_iters, 4), dtype=torch.int32, device=device)
    prep = {'outputs': (E, qm, lat, rec, cur)}
    if N == 0:
        return prep
    C, threads, placement = cluster_geometry(P, O, B, K, device_smem(device))
    layout = slice_layout(P, O, B, K, C)
    smem_bytes = layout['bytes'] if placement == 'shared' else 0
    if active_clusters(device, K, placement, C, threads, smem_bytes) == 0:
        raise RuntimeError(f'fused CSE kernel: no cluster of {C} blocks x {threads} threads with {smem_bytes} B of '
                           f'shared memory each fits on {torch.cuda.get_device_name(device)}')  # fmt: skip
    scratch = None
    if placement == 'global':
        scratch = prep['scratch'] = torch.empty(N * C * layout['bytes'], dtype=torch.uint8, device=device)
    offsets = (ctypes.c_int * (len(SLICE_REGIONS) + 1))(*(layout[n] for n in (*SLICE_REGIONS, 'bytes')))
    prep['args'] = [
        device.index, E.data_ptr(), qm.data_ptr(), lat.data_ptr(), rec.data_ptr(), cur.data_ptr(), method.data_ptr(),
        None if scratch is None else scratch.data_ptr(), None, N, P, O, B, K, spec.n_iters, spec.adder_size,
        spec.carry_size, C, threads, smem_bytes, offsets, torch.cuda.current_stream(device).cuda_stream,
    ]  # fmt: skip
    return prep


def run(prep: dict, clocks: torch.Tensor | None = None, lib=None):
    """The launch of :func:`prepare`'s arguments: ``(E, qmeta, lat, op
    records, cur)``. With ``clocks``, the phase-timing build ``lib`` writes
    its cycle counts there."""
    if 'args' in prep:
        args = prep['args']
        if clocks is not None:
            args = [*args[:8], clocks.data_ptr(), *args[9:]]
        lib = lib or load()
        _check(lib, lib.fused_cse_launch(*args), 'fused_cse launch')
    return prep['outputs']


def build_phases() -> Path:
    """Compile ``csrc/fused_cse.cu`` with ``FUSED_CSE_PHASES``: the same
    kernel, timing its phases with ``clock64`` (for measurement only)."""
    return cuda_backend.compile_source(SOURCE, (*NVCC_FLAGS, '-DFUSED_CSE_PHASES'))[0]


def phase_cycles(E, qm, lat, cur, method, spec) -> dict[str, int]:
    """One launch of the ``FUSED_CSE_PHASES`` build on these inputs (updated
    in place, as by :func:`launch`; not counted in ``launches``): the clock
    cycles lane 0's first block spent in each of ``PHASES``, summed over its
    iterations, and the iterations under ``'iterations'``."""
    clocks = torch.zeros(len(PHASES) + 1, dtype=torch.int64, device=E.device)
    run(prepare(E, qm, lat, cur, method, spec), clocks, cuda_backend.load_library(build_phases, _declare))
    vals = clocks.tolist()
    return {**dict(zip(PHASES, vals)), 'iterations': vals[-1]}

