"""HLS project writer: C++ kernel emission, g++-compiled bit-exact emulation,
and a per-flavor synthesis harness (Vitis HLS / Intel HLS / oneAPI).

    <path>/
      src/           {name}.hh kernel + dais_hls.hh helpers + bridge.cc
                     + hls_top.cc (vitis/hlslib) or hls_top_oneapi.cpp
      tcl/           build_vitis.tcl, build_hlslib.sh or build_oneapi.sh
      model/         comb.json / pipeline.json (reloadable IR)
      metadata.json

``compile()`` builds the emulation .so with plain g++ (no vendor headers
needed) into the project directory; ``predict`` is bit-exact against the
DAIS executor (``backend='interp'``: the CUDA kernel on the card, or its
plain version with ``device='cpu'``).

Counterpart of ``da4ml_tpu/codegen/hls/hls_model.py``; the project files
are the same byte for byte.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import uuid
from pathlib import Path

import numpy as np
from numpy.typing import NDArray

from ... import telemetry
from ...ir.comb import CombLogic, Pipeline
from ...ir.types import minimal_kif
from .hls_codegen import emit_hls_kernel

_SRC_DIR = Path(__file__).parent / 'source'
_logger = telemetry.get_logger('codegen.hls')


class HLSModel:
    """Write, build and drive one HLS C++ project for a DAIS program.

    ``flavor`` selects the synthesis dialect (reference hls_model.py:45):
    'vitis' (AMD Vitis HLS: HLS pragmas + Vitis TCL), 'hlslib' (Intel HLS
    compiler: ``component`` top, ii pragma, i++ build script) or 'oneapi'
    (Intel oneAPI: SYCL single_task harness, icpx build script). The kernel
    body and the g++ emulation bridge are identical across flavors — the
    explicit int64 integer code replaces the reference's per-flavor
    ap_fixed/ac_fixed type libraries, so bit-exactness is flavor-independent.
    """

    def __init__(
        self,
        solution: CombLogic | Pipeline,
        name: str,
        path: str | Path,
        latency_cutoff: float = -1,
        print_latency: bool = False,
        part: str = 'xcvu13p-flga2577-2-e',
        clock_period: float = 5.0,
        flavor: str = 'vitis',
    ):
        flavor = flavor.lower()
        if flavor not in ('vitis', 'hlslib', 'oneapi'):
            raise ValueError(f'unsupported HLS flavor {flavor!r}; expected vitis, hlslib or oneapi')
        self.flavor = flavor
        if isinstance(solution, CombLogic) and latency_cutoff > 0:
            from ...trace.pipeline import to_pipeline

            solution = to_pipeline(solution, latency_cutoff)
        self.solution = solution
        self.name = name
        self.path = Path(path)
        self.print_latency = print_latency
        self.part = part
        self.clock_period = clock_period
        self._lib: ctypes.CDLL | None = None
        self._lib_path: Path | None = None

    @property
    def is_pipeline(self) -> bool:
        return isinstance(self.solution, Pipeline)

    # ------------------------------------------------------------ layouts

    def _io_consts(self):
        sol = self.solution
        first = sol.stages[0] if self.is_pipeline else sol
        inp_kifs = [minimal_kif(q) for q in sol.inp_qint]
        out_kifs = [minimal_kif(q) for q in sol.out_qint]
        shifts = first.inp_shifts
        in_f_eff = [int(s) + f for s, (_, _, f) in zip(shifts, inp_kifs)]
        in_w = [k + i + f for k, i, f in inp_kifs]
        in_s = [int(k) for k, _, _ in inp_kifs]
        out_f = [f for _, _, f in out_kifs]
        return in_f_eff, in_w, in_s, out_f

    # ------------------------------------------------------------ emission

    def write(self) -> 'HLSModel':
        with telemetry.span('codegen.hls.write', name=self.name, flavor=self.flavor):
            return self._write()

    def _write(self) -> 'HLSModel':
        # fail-fast precondition mirroring RTLModel.write: a malformed or
        # interval-unsound program must not become a C++ kernel
        from ...analysis import codegen_verify_enabled, verify_or_raise

        if codegen_verify_enabled():
            verify_or_raise(self.solution, context=f'HLSModel.write({self.name!r}) precondition')
        src = self.path / 'src'
        src.mkdir(parents=True, exist_ok=True)
        (src / f'{self.name}.hh').write_text(emit_hls_kernel(self.solution, self.name, self.print_latency, self.flavor))
        shutil.copy(_SRC_DIR / 'dais_hls.hh', src / 'dais_hls.hh')
        (src / 'bridge.cc').write_text(self._emit_bridge())

        (self.path / 'model').mkdir(exist_ok=True)
        if self.is_pipeline:
            self.solution.save(self.path / 'model' / 'pipeline.json')
        else:
            self.solution.save(self.path / 'model' / 'comb.json')

        self._write_synth_files(src)

        lat_lo, lat_hi = self.solution.latency
        metadata = {
            'name': self.name,
            'flavor': self.flavor,
            'cost': self.solution.cost,
            'latency': [lat_lo, lat_hi],
            'clock_period': self.clock_period,
            'part': self.part,
            'pipelined': self.is_pipeline,
            'n_stages': len(self.solution.stages) if self.is_pipeline else 1,
            'inp_kifs': [tuple(int(v) for v in minimal_kif(q)) for q in self.solution.inp_qint],
            'out_kifs': [tuple(int(v) for v in minimal_kif(q)) for q in self.solution.out_qint],
        }
        (self.path / 'metadata.json').write_text(json.dumps(metadata, indent=2))
        return self

    def _write_synth_files(self, src: Path) -> None:
        """Per-flavor synthesis top + build script (the emulation path above
        is shared). Vendor tools are optional: scripts are emitted for use on
        a machine that has them (reference parity: hls_model.py:117-123)."""
        n_in = max(self.solution.shape[0], 1)
        n_out = max(self.solution.shape[1], 1)
        tdir = self.path / 'tcl'
        tdir.mkdir(exist_ok=True)
        if self.flavor == 'vitis':
            (tdir / 'build_vitis.tcl').write_text(
                f"""open_project -reset {self.name}_prj
set_top {self.name}_top
add_files src/{self.name}.hh
add_files src/dais_hls.hh
add_files src/hls_top.cc
open_solution -reset sol1
set_part {self.part}
create_clock -period {self.clock_period}
csynth_design
export_design -format ip_catalog
"""
            )
            (src / 'hls_top.cc').write_text(
                f'// Synthesis top: array interface around the inlined kernel.\n'
                f'#include "{self.name}.hh"\n'
                f'extern "C" void {self.name}_top(const int64_t in[{n_in}], int64_t out[{n_out}]) {{\n'
                f'#pragma HLS INTERFACE mode=ap_memory port=in\n'
                f'#pragma HLS INTERFACE mode=ap_memory port=out\n'
                f'    {self.name}(in, out);\n'
                f'}}\n'
            )
        elif self.flavor == 'hlslib':
            (src / 'hls_top.cc').write_text(
                f'// Intel HLS synthesis top: a component function (II pinned\n'
                f'// at the component level; the kernel body is loop-free).\n'
                f'#include "{self.name}.hh"\n'
                f'#include <HLS/hls.h>\n'
                f'hls_component_ii(1) component void {self.name}_top(const int64_t in[{n_in}], int64_t out[{n_out}]) {{\n'
                f'    {self.name}(in, out);\n'
                f'}}\n'
            )
            (tdir / 'build_hlslib.sh').write_text(
                f'#!/bin/sh\n# Intel HLS compiler flow (run where i++ is installed)\n'
                f'i++ -march="{self._intel_target()}" --clock {self.clock_period}ns -I src src/hls_top.cc -o {self.name}_prj\n'
            )
        else:  # oneapi
            (src / 'hls_top_oneapi.cpp').write_text(
                f'// oneAPI FPGA synthesis harness: SYCL single_task around the kernel.\n'
                f'#include <sycl/sycl.hpp>\n'
                f'#include "{self.name}.hh"\n'
                f'class {self.name}_kernel;\n'
                f'void {self.name}_top(sycl::queue& q, sycl::buffer<int64_t, 1>& b_in, sycl::buffer<int64_t, 1>& b_out) {{\n'
                f'    q.submit([&](sycl::handler& h) {{\n'
                f'        auto acc_in = b_in.get_access<sycl::access::mode::read>(h);\n'
                f'        auto acc_out = b_out.get_access<sycl::access::mode::write>(h);\n'
                f'        h.single_task<{self.name}_kernel>([=]() {{\n'
                f'            int64_t in[{n_in}], out[{n_out}];\n'
                f'            for (int e = 0; e < {n_in}; ++e) in[e] = acc_in[e];\n'
                f'            {self.name}(in, out);\n'
                f'            for (int e = 0; e < {n_out}; ++e) acc_out[e] = out[e];\n'
                f'        }});\n'
                f'    }});\n'
                f'}}\n'
            )
            (tdir / 'build_oneapi.sh').write_text(
                f'#!/bin/sh\n# oneAPI FPGA flow (run where icpx is installed)\n'
                f'icpx -fsycl -fintelfpga -Xshardware -Xstarget="{self._intel_target()}" '
                f'-I src src/hls_top_oneapi.cpp -o {self.name}_prj\n'
            )

    #: Intel FPGA family prefixes i++/icpx accept as -Xstarget values
    _INTEL_FAMILIES = ('agilex', 'arria', 'cyclone', 'stratix', 'max')

    def _intel_target(self) -> str:
        """Device target for the Intel flavors' build scripts.

        The class default ``part`` is an AMD Virtex part (the reference's
        default synthesis target); i++/icpx would reject it, so Intel-flavor
        scripts fall back to an Intel FPGA family unless the caller passed a
        recognizable Intel part. Unrecognized strings are substituted too
        (with a warning) rather than pasted into a build script that the
        Intel tools would reject.
        """
        part = self.part
        if part.lower().startswith(self._INTEL_FAMILIES):
            return part
        if not part.lower().startswith('xc'):
            import warnings

            warnings.warn(f'part {part!r} is not a recognizable Intel FPGA family; using Agilex7 in the Intel build script')
        return 'Agilex7'

    def _emit_bridge(self) -> str:
        in_f, in_w, in_s, out_f = self._io_consts()
        n_in, n_out = self.solution.shape

        def arr(vals):
            return '{' + ', '.join(str(v) for v in vals) + '}'

        return f"""// Generated emulation bridge: float64 batch in/out, OpenMP over samples.
#include <cmath>
#include <cstdint>
#include <omp.h>
#include "{self.name}.hh"

static const int N_IN = {n_in}, N_OUT = {n_out};
static const int IN_F[] = {arr(in_f)};
static const int IN_W[] = {arr(in_w)};
static const int IN_S[] = {arr(in_s)};
static const int OUT_F[] = {arr(out_f)};

extern "C" int inference(const double* in, double* out, long n_samples, int n_threads) {{
    if (n_threads <= 0) n_threads = omp_get_max_threads();
#pragma omp parallel for schedule(static) num_threads(n_threads)
    for (long s = 0; s < n_samples; ++s) {{
        int64_t codes[N_IN > 0 ? N_IN : 1], res[N_OUT > 0 ? N_OUT : 1];
        for (int e = 0; e < N_IN; ++e) {{
            int64_t v = int64_t(std::floor(std::ldexp(in[s * N_IN + e], IN_F[e])));
            codes[e] = da::wrap(v, IN_S[e], IN_W[e]);
        }}
        {self.name}(codes, res);
        for (int e = 0; e < N_OUT; ++e) out[s * N_OUT + e] = std::ldexp(double(res[e]), -OUT_F[e]);
    }}
    return 0;
}}
"""

    # ------------------------------------------------------------- compile

    def compile(self, verbose: bool = False) -> 'HLSModel':
        """Build the emulation .so with g++ (no vendor tools required)."""
        src = self.path / 'src'
        out = self.path / f'lib{self.name}_{uuid.uuid4().hex[:8]}.so'
        # g++ from PATH, as the native library's build takes it: a compiler
        # named by CXX need not carry OpenMP
        cxx = shutil.which('g++')
        if cxx is None:
            raise RuntimeError('g++ not found: the HLS emulator is built with g++')
        cmd = [cxx, '-std=c++17', '-O2', '-fPIC', '-shared', '-fopenmp', str(src / 'bridge.cc'), '-I', str(src), '-o', str(out)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f'HLS emulation build failed:\n{proc.stderr}')
        self._lib_path = out
        self._lib = None
        if verbose:
            _logger.info(f'built {out}')
        return self

    def _load_lib(self) -> ctypes.CDLL:
        if self._lib is not None:
            return self._lib
        if self._lib_path is None:
            libs = sorted(self.path.glob(f'lib{self.name}_*.so'))
            if not libs:
                raise RuntimeError('HLS emulator not compiled; call compile() first')
            self._lib_path = libs[-1]
        lib = ctypes.CDLL(str(self._lib_path))
        lib.inference.restype = ctypes.c_int
        lib.inference.argtypes = [
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_long,
            ctypes.c_int,
        ]
        self._lib = lib
        return lib

    # ------------------------------------------------------------- predict

    def predict(
        self, data: NDArray, backend: str = 'auto', n_threads: int = 0, device=None
    ) -> NDArray[np.float64]:
        """Bit-exact inference: 'emu' (the g++ emulation library), 'interp'
        (the DAIS executor on ``device``: the CUDA kernel on the card when
        None, its plain version with ``device='cpu'``), or 'auto' ('emu' when
        the emulator loads, else 'interp')."""
        data = np.ascontiguousarray(np.asarray(data, dtype=np.float64).reshape(len(data), -1))
        if data.shape[1] != self.solution.shape[0]:
            raise ValueError(f'Input size mismatch: expected {self.solution.shape[0]}, got {data.shape[1]}')
        if backend == 'auto':
            try:
                self._load_lib()
                backend = 'emu'
            except RuntimeError:
                backend = 'interp'
        if backend == 'interp':
            return self.solution.predict(data, device=device)
        lib = self._load_lib()
        out = np.empty((len(data), self.solution.shape[1]), dtype=np.float64)
        if n_threads <= 0:
            n_threads = int(os.environ.get('DA_DEFAULT_THREADS', 0) or 0)
        rc = lib.inference(
            data.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            len(data),
            n_threads,
        )
        if rc != 0:
            raise RuntimeError('HLS emulation inference failed')
        return out

    def __repr__(self) -> str:
        lat_lo, lat_hi = self.solution.latency
        kind = f'Pipeline[{len(self.solution.stages)}]' if self.is_pipeline else 'CombLogic'
        return f'HLSModel({self.name}: {kind}, estimated cost {self.solution.cost:.0f} LUTs, latency {lat_lo}-{lat_hi})'
