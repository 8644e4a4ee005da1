"""ctypes bindings to the port's native host library.

The sources live in ``da4ml_tpu_torch/native/src`` and are compiled with
``g++ -fopenmp`` by :mod:`.build` at first use, into ``build/da4ml_tpu_torch/``.
The library is loaded with ctypes' default ``RTLD_LOCAL``, so its exported
names never meet those of another library of the same sources in the
process. A failed build or load is kept and reported by :func:`load_error`.

Counterpart of ``da4ml_tpu/native/bindings.py`` without its fault-injection
drill point and its switch against building. ``n_threads <= 0`` leaves the
thread count to OpenMP, as do the device search's batched calls, which take
no thread count.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
from numpy.typing import NDArray

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_lib_failed: str | None = None

_ERR_LEN = 4096


def load_lib() -> ctypes.CDLL | None:
    """Load (building on demand) the native library; None if that failed."""
    global _lib, _lib_failed
    if _lib is not None:
        return _lib
    if _lib_failed is not None:
        return None
    with _lock:
        if _lib is not None:
            return _lib
        if _lib_failed is not None:
            return None
        from .build import build

        try:
            lib = ctypes.CDLL(str(build()))
        except (OSError, RuntimeError) as e:  # toolchain missing, build error, bad .so
            _lib_failed = str(e)
            return None

        lib.dais_run.restype = ctypes.c_int
        lib.dais_run.argtypes = [
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64,
            ctypes.c_char_p,
            ctypes.c_int64,
        ]
        lib.dais_program_info.restype = ctypes.c_int
        lib.dais_program_info.argtypes = [
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_char_p,
            ctypes.c_int64,
        ]
        lib.da4ml_native_abi_version.restype = ctypes.c_int
        _lib = lib
        return _lib


def load_error() -> str | None:
    return _lib_failed


def run_binary(binary: NDArray[np.int32], data: NDArray[np.float64], n_threads: int = 0) -> NDArray[np.float64]:
    """Execute a serialized DAIS program over a (n_samples, n_in) batch."""
    lib = load_lib()
    if lib is None:
        raise RuntimeError(f'Native DAIS interpreter unavailable: {_lib_failed}')
    binary = np.ascontiguousarray(binary, dtype=np.int32)
    n_in, n_out = int(binary[2]), int(binary[3])
    data = np.ascontiguousarray(data, dtype=np.float64)
    data = data.reshape(len(data), -1)
    if data.shape[1] != n_in:
        raise ValueError(f'Input size mismatch: expected {n_in}, got {data.shape[1]}')
    n_samples = data.shape[0]
    out = np.empty((n_samples, n_out), dtype=np.float64)
    err = ctypes.create_string_buffer(_ERR_LEN)
    rc = lib.dais_run(
        binary.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        binary.size,
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        n_samples,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        n_threads,
        err,
        _ERR_LEN,
    )
    if rc != 0:
        raise RuntimeError(f'dais_run failed: {err.value.decode(errors="replace")}')
    return out


def program_info(binary: NDArray[np.int32]) -> dict:
    lib = load_lib()
    if lib is None:
        raise RuntimeError(f'Native DAIS interpreter unavailable: {_lib_failed}')
    binary = np.ascontiguousarray(binary, dtype=np.int32)
    vals = [ctypes.c_int64() for _ in range(4)]
    err = ctypes.create_string_buffer(_ERR_LEN)
    rc = lib.dais_program_info(
        binary.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        binary.size,
        *[ctypes.byref(v) for v in vals],
        err,
        _ERR_LEN,
    )
    if rc != 0:
        raise RuntimeError(f'dais_program_info failed: {err.value.decode(errors="replace")}')
    n_in, n_out, n_ops, max_width = (v.value for v in vals)
    return {'n_in': n_in, 'n_out': n_out, 'n_ops': n_ops, 'max_width': max_width}


def _declare_cmvm(lib: ctypes.CDLL) -> None:
    if getattr(lib, '_cmvm_declared', False):
        return
    lib.cmvm_solve.restype = ctypes.c_void_p
    lib.cmvm_solve.argtypes = [
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_char_p,
        ctypes.c_char_p,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_char_p,
        ctypes.c_int64,
    ]
    lib.cmvm_stage_shape.restype = ctypes.c_int
    lib.cmvm_stage_shape.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.cmvm_stage_fill.restype = ctypes.c_int
    lib.cmvm_stage_fill.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.cmvm_free.restype = None
    lib.cmvm_free.argtypes = [ctypes.c_void_p]
    lib._cmvm_declared = True


def _unpack_stage(lib: ctypes.CDLL, handle: int, stage: int):
    from ..ir.comb import CombLogic
    from ..ir.types import Op, QInterval

    n_in, n_out, n_ops = (ctypes.c_int64() for _ in range(3))
    rc = lib.cmvm_stage_shape(handle, stage, *(ctypes.byref(v) for v in (n_in, n_out, n_ops)))
    if rc != 0:
        raise RuntimeError('cmvm_stage_shape failed')
    ops9 = np.empty((n_ops.value, 9), dtype=np.float64)
    inp_shifts = np.empty(n_in.value, dtype=np.int32)
    out_idxs = np.empty(n_out.value, dtype=np.int32)
    out_shifts = np.empty(n_out.value, dtype=np.int32)
    out_negs = np.empty(n_out.value, dtype=np.int32)
    rc = lib.cmvm_stage_fill(
        handle,
        stage,
        ops9.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        inp_shifts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out_idxs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out_shifts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out_negs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if rc != 0:
        raise RuntimeError('cmvm_stage_fill failed')
    ops = [
        Op(int(r[0]), int(r[1]), int(r[2]), int(r[3]), QInterval(r[4], r[5], r[6]), float(r[7]), float(r[8]))
        for r in ops9
    ]
    return CombLogic(
        shape=(n_in.value, n_out.value),
        inp_shifts=[int(v) for v in inp_shifts],
        out_idxs=[int(v) for v in out_idxs],
        out_shifts=[int(v) for v in out_shifts],
        out_negs=[bool(v) for v in out_negs],
        ops=ops,
        carry_size=-1,
        adder_size=-1,
    )


def solve_native(
    kernel,
    method0: str = 'wmc',
    method1: str = 'auto',
    hard_dc: int = -1,
    decompose_dc: int = -2,
    qintervals=None,
    latencies=None,
    adder_size: int = -1,
    carry_size: int = -1,
    search_all_decompose_dc: bool = True,
    n_threads: int = 0,
):
    """Full CMVM solve in the native library; returns an ir.Pipeline.

    Decision-identical with the Python host solver (cmvm/api.py solve),
    parallelized over decompose-depth candidates with OpenMP
    (reference: api.cc:194-238).
    """
    from ..ir.comb import Pipeline
    from ..ir.types import QInterval

    lib = load_lib()
    if lib is None:
        raise RuntimeError(f'Native CMVM solver unavailable: {_lib_failed}')
    _declare_cmvm(lib)

    kernel = np.ascontiguousarray(kernel, dtype=np.float64)
    if kernel.ndim != 2 or kernel.shape[0] == 0 or kernel.shape[1] == 0:
        raise ValueError(f'kernel must be a non-empty 2D matrix, got shape {kernel.shape}')
    n_in, n_out = kernel.shape
    if not qintervals:
        qintervals = [QInterval(-128.0, 127.0, 1.0)] * n_in
    if not latencies:
        latencies = [0.0] * n_in
    qarr = np.ascontiguousarray([[q[0], q[1], q[2]] for q in qintervals], dtype=np.float64)
    larr = np.ascontiguousarray(latencies, dtype=np.float64)
    if len(qarr) != n_in or len(larr) != n_in:
        raise ValueError('qintervals/latencies length must match kernel rows')

    err = ctypes.create_string_buffer(_ERR_LEN)
    handle = lib.cmvm_solve(
        kernel.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        n_in,
        n_out,
        method0.encode(),
        method1.encode(),
        hard_dc,
        decompose_dc,
        qarr.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        larr.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        adder_size,
        carry_size,
        int(search_all_decompose_dc),
        n_threads,
        err,
        _ERR_LEN,
    )
    if not handle:
        raise RuntimeError(f'cmvm_solve failed: {err.value.decode(errors="replace")}')
    try:
        sol0 = _unpack_stage(lib, handle, 0)
        sol1 = _unpack_stage(lib, handle, 1)
    finally:
        lib.cmvm_free(handle)
    sol0 = sol0._replace(carry_size=carry_size, adder_size=adder_size)
    sol1 = sol1._replace(carry_size=carry_size, adder_size=adder_size)
    return Pipeline(stages=(sol0, sol1))


def _declare_emit(lib: ctypes.CDLL) -> None:
    if getattr(lib, '_emit_declared', False):
        return
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i8p = ctypes.POINTER(ctypes.c_int8)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.cmvm_emit_batch.restype = ctypes.c_void_p
    lib.cmvm_emit_batch.argtypes = [
        ctypes.c_int64, i64p, i32p, i32p, f64p, f64p, i8p, i32p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64,
    ]
    lib.cmvm_emit_shape.restype = ctypes.c_int
    lib.cmvm_emit_shape.argtypes = [ctypes.c_void_p, ctypes.c_int64, i64p, i64p, i64p]
    lib.cmvm_emit_fill.restype = ctypes.c_int
    lib.cmvm_emit_fill.argtypes = [ctypes.c_void_p, ctypes.c_int64, f64p, i32p, i32p, i32p, i32p]
    lib.cmvm_emit_free.restype = None
    lib.cmvm_emit_free.argtypes = [ctypes.c_void_p]
    lib.cmvm_decompose_batch.restype = ctypes.c_int
    lib.cmvm_decompose_batch.argtypes = [
        ctypes.c_int64, i64p, f64p, f64p, f64p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64,
    ]
    lib._emit_declared = True


def has_emit() -> bool:
    lib = load_lib()
    return lib is not None and hasattr(lib, 'cmvm_emit_batch')


class RawComb:
    """Array-backed solution handle: cheap cost/latency/qint accessors, with
    the full :class:`~da4ml_tpu_torch.ir.comb.CombLogic` materialized only on demand
    (candidate solutions that lose the decompose-dc argmin are never built)."""

    __slots__ = ('shape', 'inp_shifts', 'out_idxs', 'out_shifts', 'out_negs', 'ops9', 'adder_size', 'carry_size')

    def __init__(self, shape, inp_shifts, out_idxs, out_shifts, out_negs, ops9, adder_size, carry_size):
        self.shape = shape
        self.inp_shifts = inp_shifts
        self.out_idxs = out_idxs
        self.out_shifts = out_shifts
        self.out_negs = out_negs
        self.ops9 = ops9
        self.adder_size = adder_size
        self.carry_size = carry_size

    @property
    def cost(self) -> float:
        return float(self.ops9[:, 8].sum())

    @property
    def out_latency(self) -> list[float]:
        lat = self.ops9[:, 7]
        return [float(lat[i]) if i >= 0 else 0.0 for i in self.out_idxs]

    @property
    def out_qint(self) -> list:
        from ..ir.types import QInterval

        out = []
        for i, idx in enumerate(self.out_idxs):
            if idx < 0:
                out.append(QInterval(0.0, 0.0, 1.0))
                continue
            lo, hi, step = self.ops9[idx, 4:7]
            sf = 2.0 ** float(self.out_shifts[i])
            lo, hi, step = lo * sf, hi * sf, step * sf
            if self.out_negs[i]:
                lo, hi = -hi, -lo
            out.append(QInterval(float(lo), float(hi), float(step)))
        return out

    def to_comb(self):
        from ..ir.comb import CombLogic
        from ..ir.types import Op, QInterval

        # tolist() converts the whole array to python scalars in C — much
        # faster than per-element numpy indexing for the big op arrays
        ops = [
            Op(int(a), int(b), int(c), int(d), QInterval(e, f, g), h, i)
            for a, b, c, d, e, f, g, h, i in self.ops9.tolist()
        ]
        return CombLogic(
            shape=self.shape,
            inp_shifts=[int(v) for v in self.inp_shifts],
            out_idxs=[int(v) for v in self.out_idxs],
            out_shifts=[int(v) for v in self.out_shifts],
            out_negs=[bool(v) for v in self.out_negs],
            ops=ops,
            carry_size=self.carry_size,
            adder_size=self.adder_size,
        )


def emit_batch(
    lanes: list[tuple],
    adder_size: int,
    carry_size: int,
) -> list[RawComb]:
    """Batched adder-tree emission from device search decisions.

    Each lane is ``(shift0 [ni] i32, shift1 [no] i32, qints [ni,3] f64,
    lats [ni] f64, E [(ni+n_add), no, nb] i8, rec [n_add,4] i32)``.
    Returns one :class:`RawComb` array handle per lane (OpenMP over lanes;
    reference pattern api.cc:208-238).
    """
    lib = load_lib()
    if lib is None:
        raise RuntimeError(f'Native emission unavailable: {_lib_failed}')
    _declare_emit(lib)

    n_lanes = len(lanes)
    geo = np.empty((n_lanes, 4), dtype=np.int64)
    s0_l, s1_l, q_l, la_l, E_l, r_l = [], [], [], [], [], []
    for x, (shift0, shift1, qints, lats, E, rec) in enumerate(lanes):
        ni = len(shift0)
        no = len(shift1)
        n_add = len(rec)
        nb = E.shape[2] if E.ndim == 3 else 0
        geo[x] = (ni, no, nb, n_add)
        s0_l.append(np.ascontiguousarray(shift0, dtype=np.int32))
        s1_l.append(np.ascontiguousarray(shift1, dtype=np.int32))
        q_l.append(np.ascontiguousarray(qints, dtype=np.float64).reshape(ni, 3))
        la_l.append(np.ascontiguousarray(lats, dtype=np.float64))
        E_l.append(np.ascontiguousarray(E, dtype=np.int8).reshape(-1))
        r_l.append(np.ascontiguousarray(rec, dtype=np.int32).reshape(-1))
    shift0s = np.concatenate(s0_l) if s0_l else np.zeros(0, np.int32)
    shift1s = np.concatenate(s1_l) if s1_l else np.zeros(0, np.int32)
    qints_f = np.concatenate(q_l).reshape(-1) if q_l else np.zeros(0, np.float64)
    lats_f = np.concatenate(la_l) if la_l else np.zeros(0, np.float64)
    E_f = np.concatenate(E_l) if E_l else np.zeros(0, np.int8)
    rec_f = np.concatenate(r_l) if r_l else np.zeros(0, np.int32)

    err = ctypes.create_string_buffer(_ERR_LEN)
    handle = lib.cmvm_emit_batch(
        n_lanes,
        geo.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        shift0s.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        shift1s.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        qints_f.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        lats_f.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        E_f.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        rec_f.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        adder_size,
        carry_size,
        0,
        err,
        _ERR_LEN,
    )
    if not handle:
        raise RuntimeError(f'cmvm_emit_batch failed: {err.value.decode(errors="replace")}')
    try:
        out = []
        for x in range(n_lanes):
            n_in, n_out, n_ops = (ctypes.c_int64() for _ in range(3))
            rc = lib.cmvm_emit_shape(handle, x, *(ctypes.byref(v) for v in (n_in, n_out, n_ops)))
            if rc != 0:
                raise RuntimeError('cmvm_emit_shape failed')
            ops9 = np.empty((n_ops.value, 9), dtype=np.float64)
            inp_shifts = np.empty(n_in.value, dtype=np.int32)
            out_idxs = np.empty(n_out.value, dtype=np.int32)
            out_shifts = np.empty(n_out.value, dtype=np.int32)
            out_negs = np.empty(n_out.value, dtype=np.int32)
            rc = lib.cmvm_emit_fill(
                handle,
                x,
                ops9.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                inp_shifts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                out_idxs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                out_shifts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                out_negs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            )
            if rc != 0:
                raise RuntimeError('cmvm_emit_fill failed')
            out.append(
                RawComb(
                    (n_in.value, n_out.value), inp_shifts, out_idxs, out_shifts, out_negs, ops9, adder_size, carry_size
                )
            )
        return out
    finally:
        lib.cmvm_emit_free(handle)


def decompose_batch(
    kernels: list[NDArray[np.float64]],
    dcs: list[int],
) -> list[tuple[NDArray[np.float64], NDArray[np.float64]]]:
    """Batched ``kernel_decompose`` (OpenMP over lanes): m0 @ m1 == kernel."""
    lib = load_lib()
    if lib is None:
        raise RuntimeError(f'Native decomposition unavailable: {_lib_failed}')
    _declare_emit(lib)

    n_lanes = len(kernels)
    geo = np.empty((n_lanes, 3), dtype=np.int64)
    k_l = []
    n_k = n_m1 = 0
    for x, (k, dc) in enumerate(zip(kernels, dcs)):
        k = np.ascontiguousarray(k, dtype=np.float64)
        ni, no = k.shape
        geo[x] = (ni, no, dc)
        k_l.append(k.reshape(-1))
        n_k += ni * no
        n_m1 += no * no
    kern_f = np.concatenate(k_l) if k_l else np.zeros(0, np.float64)
    m0_out = np.zeros(n_k, dtype=np.float64)
    m1_out = np.zeros(n_m1, dtype=np.float64)
    err = ctypes.create_string_buffer(_ERR_LEN)
    rc = lib.cmvm_decompose_batch(
        n_lanes,
        geo.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        kern_f.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        m0_out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        m1_out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        0,
        err,
        _ERR_LEN,
    )
    if rc != 0:
        raise RuntimeError(f'cmvm_decompose_batch failed: {err.value.decode(errors="replace")}')
    out = []
    ok = om = 0
    for x in range(n_lanes):
        ni, no = int(geo[x, 0]), int(geo[x, 1])
        out.append((m0_out[ok : ok + ni * no].reshape(ni, no), m1_out[om : om + no * no].reshape(no, no)))
        ok += ni * no
        om += no * no
    return out
