"""RTL project writer: Verilog (and VHDL) emission, Verilator emulation
binder, vendor build scripts, and bit-exact ``predict``.

``RTLModel`` takes a CombLogic or Pipeline, optionally re-times it to a
latency cutoff, and writes a self-contained project:

    <path>/
      src/            *.v stage modules + top + wrapper + primitives + .mem
      binder/         Verilator C++ binder + Makefile (emulation .so)
      tcl/            Vivado / Quartus out-of-context build scripts
      constraints/    clock constraints (.xdc / .sdc)
      model/          pipeline.json (reloadable IR)
      metadata.json   cost / latency / io-map summary

``predict`` runs the Verilator-compiled emulator when available
(``compile()``; requires verilator in PATH) and falls back to the bit-exact
DAIS executor with ``backend='interp'`` (the CUDA kernel on the card, or its
plain version with ``device='cpu'``); ``backend='netlist'`` executes the
emitted HDL in the port's pure-Python netlist simulator.

Counterpart of ``da4ml_tpu/codegen/rtl/rtl_model.py``.
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
from ..rtl.verilog.comb import VerilogCombEmitter
from ..rtl.verilog.io_wrapper import emit_io_wrapper
from ..rtl.verilog.pipeline import emit_pipeline

_logger = telemetry.get_logger('codegen.rtl')

_SRC_DIR = Path(__file__).parent / 'verilog' / 'source'
_VHDL_SRC_DIR = Path(__file__).parent / 'vhdl' / 'source'
_COMMON_DIR = Path(__file__).parent / 'common'

PRIMITIVES = [
    'shift_adder.v',
    'negative.v',
    'quantizer.v',
    'relu.v',
    'msb_mux.v',
    'multiplier.v',
    'lookup_table.v',
    'bit_binop.v',
    'bit_unary.v',
]

VHDL_PRIMITIVES = [
    'da4ml_util.vhd',
    'shift_adder.vhd',
    'negative.vhd',
    'quantizer.vhd',
    'relu.vhd',
    'msb_mux.vhd',
    'multiplier.vhd',
    'lookup_table.vhd',
    'bit_binop.vhd',
    'bit_unary.vhd',
]


class RTLModel:
    """Write, build and drive one RTL project for a DAIS program."""

    flavor = 'verilog'
    # HDL name of the wrapper's output port ('out' is reserved in VHDL, so
    # the VHDL flavor renames it; the binder must address the same name).
    _hdl_out_port = 'out'

    def __init__(
        self,
        solution: CombLogic | Pipeline,
        name: str,
        path: str | Path,
        latency_cutoff: float = -1,
        print_latency: bool = False,
        part: str = 'xcvu13p-flga2577-2-e',
        clock_period: float = 5.0,
        clock_uncertainty: float = 0.1,
        register_layers: int = 1,
        io_delay_minmax: tuple[float, float] = (0.2, 0.4),
    ):
        if isinstance(solution, CombLogic) and latency_cutoff > 0:
            from ...trace.pipeline import to_pipeline

            solution = to_pipeline(solution, latency_cutoff)
        self.solution = solution
        self.name = name
        self.path = Path(path)
        self.print_latency = print_latency
        self.part = part
        self.clock_period = clock_period
        self.clock_uncertainty = clock_uncertainty
        self.register_layers = register_layers
        self.io_delay_minmax = io_delay_minmax
        self._lib: ctypes.CDLL | None = None
        self._lib_path: Path | None = None

    # ----------------------------------------------------------- properties

    @property
    def is_pipeline(self) -> bool:
        return isinstance(self.solution, Pipeline)

    @property
    def latency_ticks(self) -> int:
        """Clock ticks from input to output (register layers between stages)."""
        if not self.is_pipeline:
            return 0
        return (len(self.solution.stages) - 1) * max(self.register_layers, 1)

    @property
    def cost(self) -> float:
        return self.solution.cost

    # ------------------------------------------------------------ emission

    def _emit(self) -> tuple[dict[str, str], dict]:
        """Returns ({filename: text}, metadata)."""
        files: dict[str, str] = {}
        if self.is_pipeline:
            top_text, mem_files, stage_texts = emit_pipeline(
                self.solution, self.name, self.print_latency, self.register_layers
            )
            for si, text in enumerate(stage_texts):
                files[f'{self.name}_s{si}.v'] = text
            files[f'{self.name}.v'] = top_text
            files.update(mem_files)
            clocked = True
        else:
            em = VerilogCombEmitter(self.solution, self.name, self.print_latency)
            files[f'{self.name}.v'] = em.emit()
            files.update(em.mem_files)
            clocked = False

        wrapper_text, in_map, out_map = emit_io_wrapper(self.solution, f'{self.name}_wrapper', self.name, clocked)
        files[f'{self.name}_wrapper.v'] = wrapper_text

        inp_kifs = [tuple(int(v) for v in minimal_kif(q)) for q in self.solution.inp_qint]
        out_kifs = [tuple(int(v) for v in minimal_kif(q)) for q in self.solution.out_qint]
        lat_lo, lat_hi = self.solution.latency
        metadata = {
            'name': self.name,
            'flavor': self.flavor,
            'cost': self.solution.cost,
            'latency': [lat_lo, lat_hi],
            'latency_ticks': self.latency_ticks,
            'clock_period': self.clock_period,
            'clock_uncertainty': self.clock_uncertainty,
            'part': self.part,
            'pipelined': self.is_pipeline,
            'n_stages': len(self.solution.stages) if self.is_pipeline else 1,
            'reg_bits': self.solution.reg_bits if self.is_pipeline else 0,
            'inp_kifs': inp_kifs,
            'out_kifs': out_kifs,
            'in_lane_width': in_map.lane_width,
            'out_lane_width': out_map.lane_width,
            'in_elems': in_map.elems,
            'out_elems': out_map.elems,
        }
        return files, metadata

    def write(self) -> 'RTLModel':
        with telemetry.span('codegen.rtl.write', name=self.name, flavor=self.flavor):
            return self._write()

    def _write(self) -> 'RTLModel':
        # fail-fast precondition: refuse to emit HDL for a malformed or
        # interval-unsound program (set DA4ML_VERIFY=0 to bypass)
        from ...analysis import codegen_verify_enabled, verify_or_raise

        if codegen_verify_enabled():
            verify_or_raise(self.solution, context=f'{type(self).__name__}.write({self.name!r}) precondition')
        files, metadata = self._emit()
        src = self.path / 'src'
        src.mkdir(parents=True, exist_ok=True)
        for fname, text in files.items():
            (src / fname).write_text(text)
        prim_dir = _SRC_DIR if self.flavor == 'verilog' else _VHDL_SRC_DIR
        prims = PRIMITIVES if self.flavor == 'verilog' else VHDL_PRIMITIVES
        for prim in prims:
            shutil.copy(prim_dir / prim, src / prim)

        (self.path / 'model').mkdir(exist_ok=True)
        if self.is_pipeline:
            self.solution.save(self.path / 'model' / 'pipeline.json')
        else:
            self.solution.save(self.path / 'model' / 'comb.json')

        (self.path / 'metadata.json').write_text(json.dumps(metadata, indent=2))
        self._write_constraints()
        self._write_tcl()
        self._write_binder(metadata)
        return self

    def _subst(self, text: str) -> str:
        """Resolve @TOKEN@ placeholders in a flow/constraint template."""
        d_min, d_max = self.io_delay_minmax
        tokens = {
            'NAME': self.name,
            'PART': self.part,
            'FLAVOR': self.flavor,
            'CLOCK_PERIOD': str(self.clock_period),
            'UNCERTAINTY_SETUP': str(self.clock_uncertainty),
            'UNCERTAINTY_HOLD': str(self.clock_uncertainty),
            'DELAY_MIN': str(d_min),
            'DELAY_MAX': str(d_max),
        }
        for key, val in tokens.items():
            text = text.replace(f'@{key}@', val)
        return text

    def _write_constraints(self):
        cdir = self.path / 'constraints'
        cdir.mkdir(exist_ok=True)
        if self.is_pipeline:
            for ext in ('xdc', 'sdc'):
                template = (_COMMON_DIR / f'constraints.{ext}').read_text()
                (cdir / f'{self.name}.{ext}').write_text(self._subst(template))
        else:
            (cdir / f'{self.name}.xdc').write_text('# combinational block: no clock\n')

    def _write_tcl(self):
        tdir = self.path / 'tcl'
        tdir.mkdir(exist_ok=True)
        for vendor in ('vivado', 'quartus'):
            template = (_COMMON_DIR / f'{vendor}_flow.tcl').read_text()
            (tdir / f'build_{vendor}.tcl').write_text(self._subst(template))

    # ------------------------------------------------------------- binder

    def _write_binder(self, metadata: dict):
        bdir = self.path / 'binder'
        bdir.mkdir(exist_ok=True)
        shutil.copy(_COMMON_DIR / 'binder_util.hh', bdir / 'binder_util.hh')

        top = f'{self.name}_wrapper'
        lw_in, lw_out = metadata['in_lane_width'], metadata['out_lane_width']
        n_in, n_out = len(metadata['in_elems']), len(metadata['out_elems'])
        in_signed = [int(s) for _, _, s, _ in metadata['in_elems']]
        out_signed = [int(s) for _, _, s, _ in metadata['out_elems']]
        in_widths = [w for _, w, _, _ in metadata['in_elems']]
        out_widths = [w for _, w, _, _ in metadata['out_elems']]
        lat = metadata['latency_ticks']
        clocked = metadata['pipelined']

        def arr(vals):
            return '{' + ', '.join(str(v) for v in vals) + '}'

        binder = f"""// Generated Verilator binder for {top}: int64 codes in/out, OpenMP batch.
#include <omp.h>
#include <vector>
#include "V{top}.h"
#include "binder_util.hh"

using namespace da4ml_binder;

static const int N_IN = {n_in}, N_OUT = {n_out};
static const int LW_IN = {lw_in}, LW_OUT = {lw_out};
static const int LAT = {lat};
static const int IN_W[] = {arr(in_widths)};
static const int OUT_W[] = {arr(out_widths)};
static const int OUT_S[] = {arr(out_signed)};
static const int IN_S[] = {arr(in_signed)};

static void run_chunk(const int64_t* in, int64_t* out, long n) {{
    VerilatedContext ctx;
    V{top} top{{&ctx}};
"""
        outp = self._hdl_out_port
        if clocked:
            binder += f"""    long total = n + LAT;
    for (long t = 0; t < total; ++t) {{
        if (t < n)
            for (int e = 0; e < N_IN; ++e)
                set_bits(top.inp, e * LW_IN, IN_W[e] ? IN_W[e] : 1, uint64_t(in[t * N_IN + e]));
        top.clk = 0; top.eval();
        if (t >= LAT) {{
            long s = t - LAT;
            for (int e = 0; e < N_OUT; ++e)
                out[s * N_OUT + e] = sext(get_bits(top.{outp}, e * LW_OUT, OUT_W[e] ? OUT_W[e] : 1), OUT_W[e], OUT_S[e]);
        }}
        top.clk = 1; top.eval();
    }}
"""
        else:
            binder += f"""    for (long s = 0; s < n; ++s) {{
        for (int e = 0; e < N_IN; ++e)
            set_bits(top.inp, e * LW_IN, IN_W[e] ? IN_W[e] : 1, uint64_t(in[s * N_IN + e]));
        top.eval();
        for (int e = 0; e < N_OUT; ++e)
            out[s * N_OUT + e] = sext(get_bits(top.{outp}, e * LW_OUT, OUT_W[e] ? OUT_W[e] : 1), OUT_W[e], OUT_S[e]);
    }}
"""
        binder += """}

extern "C" int inference(const int64_t* in, int64_t* out, long n_samples, int n_threads) {
    if (n_threads <= 0) n_threads = omp_get_max_threads();
    long chunk = (n_samples + n_threads - 1) / n_threads;
    if (chunk < 32) chunk = 32;
    long n_chunks = (n_samples + chunk - 1) / chunk;
#pragma omp parallel for schedule(static) num_threads(n_threads)
    for (long c = 0; c < n_chunks; ++c) {
        long lo = c * chunk, hi = lo + chunk > n_samples ? n_samples : lo + chunk;
        run_chunk(in + lo * N_IN, out + lo * N_OUT, hi - lo);
    }
    return 0;
}
"""
        (bdir / 'binder.cc').write_text(binder)

        makefile = f"""TOP = {top}
VERILATOR ?= verilator
VERILATOR_ROOT ?= $(shell $(VERILATOR) --getenv VERILATOR_ROOT)
CXX ?= g++
SO = lib$(TOP).so

all: $(SO)

obj_dir/V$(TOP)__ALL.a: ../src/*.v
\t$(VERILATOR) --cc ../src/$(TOP).v -y ../src --Mdir obj_dir --build -j 0 -O3 --top-module $(TOP)

$(SO): binder.cc obj_dir/V$(TOP)__ALL.a
\t$(CXX) -O2 -fPIC -shared -fopenmp -std=c++17 -Iobj_dir -I$(VERILATOR_ROOT)/include \\
\t  binder.cc obj_dir/V$(TOP)__ALL.a \\
\t  $(VERILATOR_ROOT)/include/verilated.cpp $(VERILATOR_ROOT)/include/verilated_threads.cpp \\
\t  -o $(SO)

clean:
\trm -rf obj_dir $(SO)
"""
        (bdir / 'Makefile').write_text(makefile)

    # ------------------------------------------------------------- compile

    @staticmethod
    def emulation_available() -> bool:
        return shutil.which('verilator') is not None

    def compile(self, verbose: bool = False) -> 'RTLModel':
        """Build the Verilator emulation .so (requires verilator in PATH)."""
        if not self.emulation_available():
            raise RuntimeError('verilator not found in PATH; RTL emulation unavailable (use predict backend="interp")')
        bdir = self.path / 'binder'
        # copy .mem files next to the obj_dir so $readmemh resolves
        for mem in (self.path / 'src').glob('*.mem'):
            shutil.copy(mem, bdir / mem.name)
        env = os.environ.copy()
        proc = subprocess.run(['make', '-C', str(bdir)], capture_output=True, text=True, env=env)
        if proc.returncode != 0:
            raise RuntimeError(f'RTL emulation build failed:\n{proc.stdout}\n{proc.stderr}')
        built = bdir / f'lib{self.name}_wrapper.so'
        stamped = bdir / f'lib{self.name}_{uuid.uuid4().hex[:8]}.so'
        shutil.move(built, stamped)
        self._lib_path = stamped
        self._lib = None
        if verbose:
            _logger.info(f'built {stamped}')
        return self

    def _load_lib(self) -> ctypes.CDLL:
        if self._lib is not None:
            return self._lib
        if self._lib_path is None:
            libs = sorted((self.path / 'binder').glob(f'lib{self.name}_*.so'))
            if not libs:
                raise RuntimeError('emulator not compiled; call compile() first')
            self._lib_path = libs[-1]
        lib = ctypes.CDLL(str(self._lib_path))
        lib.inference.restype = ctypes.c_int
        lib.inference.argtypes = [
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_long,
            ctypes.c_int,
        ]
        self._lib = lib
        return lib

    # ------------------------------------------------------------- predict

    def _to_codes(self, data: NDArray) -> NDArray[np.int64]:
        """Float inputs -> integer codes: wrap(floor(x * 2**(inp_shift + f)))."""
        first = self.solution.stages[0] if self.is_pipeline else self.solution
        codes = np.empty(data.shape, dtype=np.int64)
        for e, qi in enumerate(self.solution.inp_qint):
            k, i, f = minimal_kif(qi)
            w = k + i + f
            v = np.floor(data[:, e] * 2.0 ** (f + int(first.inp_shifts[e]))).astype(np.int64)
            if w <= 0:
                codes[:, e] = 0
                continue
            mod = np.int64(1) << w
            int_min = -(np.int64(1) << (w - 1)) if k else np.int64(0)
            codes[:, e] = (((v - int_min) % mod) + int_min) & (mod - 1)
        return codes

    def _from_codes(self, codes: NDArray[np.int64]) -> NDArray[np.float64]:
        out = np.empty(codes.shape, dtype=np.float64)
        for e, qi in enumerate(self.solution.out_qint):
            _, _, f = minimal_kif(qi)
            out[:, e] = codes[:, e].astype(np.float64) * 2.0**-f
        return out

    def predict(
        self, data: NDArray, backend: str = 'auto', n_threads: int = 0, device=None
    ) -> NDArray[np.float64]:
        """Bit-exact inference: 'emu' (Verilator .so), 'interp' (the DAIS
        executor on ``device``: the CUDA kernel on the card when None, its
        plain version with ``device='cpu'``), 'netlist' (execute the emitted
        HDL in the bundled simulator — the clocked pipelined top for
        pipelines), or 'auto' ('emu' when the emulator loads, else 'interp')."""
        data = np.asarray(data, dtype=np.float64).reshape(len(data), -1)
        if backend == 'auto':
            try:
                self._load_lib()
                backend = 'emu'
            except RuntimeError:
                backend = 'interp'
        if backend == 'interp':
            return self.solution.predict(data, device=device)
        if backend == 'netlist':
            if self.flavor == 'verilog':
                from .verilog.netlist_sim import simulate_comb, simulate_pipeline

                if self.is_pipeline:
                    return simulate_pipeline(self.solution, self.name, data, self.register_layers)
                return simulate_comb(self.solution, self.name, data)
            from .vhdl.netlist_sim import simulate_comb_vhdl, simulate_pipeline_vhdl

            if self.is_pipeline:
                return simulate_pipeline_vhdl(self.solution, self.name, data, self.register_layers)
            return simulate_comb_vhdl(self.solution, self.name, data)
        lib = self._load_lib()
        codes = np.ascontiguousarray(self._to_codes(data))
        out = np.empty((len(data), len(self.solution.out_qint)), dtype=np.int64)
        if n_threads <= 0:
            n_threads = int(os.environ.get('DA_DEFAULT_THREADS', 0) or 0)
        rc = lib.inference(
            codes.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(data),
            n_threads,
        )
        if rc != 0:
            raise RuntimeError('RTL emulation inference failed')
        return self._from_codes(out)

    def __repr__(self) -> str:
        lat_lo, lat_hi = self.solution.latency
        kind = f'Pipeline[{len(self.solution.stages)}]' if self.is_pipeline else 'CombLogic'
        return (
            f'{type(self).__name__}({self.name}: {kind}, estimated cost {self.cost:.0f} LUTs, '
            f'latency {lat_lo}-{lat_hi}, {self.latency_ticks} ticks @ {self.clock_period} ns)'
        )


class VerilogModel(RTLModel):
    flavor = 'verilog'


class VHDLModel(RTLModel):
    """VHDL-2008 flavor: same project layout with .vhd sources.

    The emulation path GHDL-synthesizes the VHDL to Verilog first (see the
    binder Makefile); where GHDL is absent the bundled VHDL netlist
    simulator (vhdl/netlist_sim.py) provides the generated-code oracle.
    """

    flavor = 'vhdl'
    _hdl_out_port = 'out_port'

    def _emit(self):
        from .vhdl.comb import VHDLCombEmitter
        from .vhdl.io_wrapper import emit_io_wrapper_vhdl
        from .vhdl.pipeline import emit_pipeline_vhdl

        files: dict[str, str] = {}
        if self.is_pipeline:
            top_text, mem_files, stage_texts = emit_pipeline_vhdl(
                self.solution, self.name, self.print_latency, self.register_layers
            )
            for si, text in enumerate(stage_texts):
                files[f'{self.name}_s{si}.vhd'] = text
            files[f'{self.name}.vhd'] = top_text
            files.update(mem_files)
            clocked = True
        else:
            em = VHDLCombEmitter(self.solution, self.name, self.print_latency)
            files[f'{self.name}.vhd'] = em.emit()
            files.update(em.mem_files)
            clocked = False

        wrapper_text, in_map, out_map = emit_io_wrapper_vhdl(self.solution, f'{self.name}_wrapper', self.name, clocked)
        files[f'{self.name}_wrapper.vhd'] = wrapper_text

        inp_kifs = [tuple(int(v) for v in minimal_kif(q)) for q in self.solution.inp_qint]
        out_kifs = [tuple(int(v) for v in minimal_kif(q)) for q in self.solution.out_qint]
        lat_lo, lat_hi = self.solution.latency
        metadata = {
            'name': self.name,
            'flavor': self.flavor,
            'cost': self.solution.cost,
            'latency': [lat_lo, lat_hi],
            'latency_ticks': self.latency_ticks,
            'clock_period': self.clock_period,
            'clock_uncertainty': self.clock_uncertainty,
            'part': self.part,
            'pipelined': self.is_pipeline,
            'n_stages': len(self.solution.stages) if self.is_pipeline else 1,
            'reg_bits': self.solution.reg_bits if self.is_pipeline else 0,
            'inp_kifs': inp_kifs,
            'out_kifs': out_kifs,
            'in_lane_width': in_map.lane_width,
            'out_lane_width': out_map.lane_width,
            'in_elems': in_map.elems,
            'out_elems': out_map.elems,
        }
        return files, metadata

    def _write_binder(self, metadata: dict):
        super()._write_binder(metadata)
        # GHDL-synthesize the VHDL to Verilog before the Verilator step
        bdir = self.path / 'binder'
        top = f'{self.name}_wrapper'
        # GHDL analyzes in command-line order: util + primitives first, then
        # stages (instantiated by the top), then the top, then the wrapper.
        srcs = ['da4ml_util.vhd'] + [p for p in VHDL_PRIMITIVES if p != 'da4ml_util.vhd']
        if self.is_pipeline:
            srcs += [f'{self.name}_s{si}.vhd' for si in range(len(self.solution.stages))]
        srcs += [f'{self.name}.vhd', f'{self.name}_wrapper.vhd']
        src_list = ' '.join(f'../src/{s}' for s in srcs)
        makefile = f"""TOP = {top}
VERILATOR ?= verilator
VERILATOR_ROOT ?= $(shell $(VERILATOR) --getenv VERILATOR_ROOT)
GHDL ?= ghdl
CXX ?= g++
SO = lib$(TOP).so
SRCS = {src_list}

all: $(SO)

$(TOP).v: $(SRCS)
\t$(GHDL) -a --std=08 $(SRCS)
\t$(GHDL) synth --std=08 --out=verilog $(TOP) > $(TOP).v

obj_dir/V$(TOP)__ALL.a: $(TOP).v
\t$(VERILATOR) --cc $(TOP).v --Mdir obj_dir --build -j 0 -O3 --top-module $(TOP)

$(SO): binder.cc obj_dir/V$(TOP)__ALL.a
\t$(CXX) -O2 -fPIC -shared -fopenmp -std=c++17 -Iobj_dir -I$(VERILATOR_ROOT)/include \\
\t  binder.cc obj_dir/V$(TOP)__ALL.a \\
\t  $(VERILATOR_ROOT)/include/verilated.cpp $(VERILATOR_ROOT)/include/verilated_threads.cpp \\
\t  -o $(SO)

clean:
\trm -rf obj_dir $(SO) $(TOP).v work-obj08.cf
"""
        (bdir / 'Makefile').write_text(makefile)

    @staticmethod
    def emulation_available() -> bool:
        return shutil.which('verilator') is not None and shutil.which('ghdl') is not None
