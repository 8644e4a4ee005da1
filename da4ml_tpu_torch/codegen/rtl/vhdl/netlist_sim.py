"""Bit-exact netlist simulator front-end for the emitted VHDL subset.

Parses VHDLCombEmitter output (signal declarations, concurrent assignments,
entity instantiations) into the same internal structures as the Verilog
netlist simulator and reuses its primitive evaluation engine, providing a
generated-VHDL oracle on hosts without GHDL.

Counterpart of ``da4ml_tpu/codegen/rtl/vhdl/netlist_sim.py``.
"""

from __future__ import annotations

import re

import numpy as np
from numpy.typing import NDArray

from ..verilog.netlist_sim import PipelineNetlistSim, VerilogNetlistSim, _Instance, _mask, _sext, _shr

_RE_SIG = re.compile(r'signal\s+(\w+)\s*:\s*(std_logic_vector|signed|unsigned)\((\d+)\s+downto\s+0\);')
_RE_ASSIGN = re.compile(r'(\w+)(?:\((\d+)\s+downto\s+(\d+)\))?\s*<=\s*(.+?);')
_RE_INST = re.compile(r'\w+\s*:\s*entity\s+work\.(\w+)\s+generic map\s*\((.*?)\)\s*port map\s*\((.*?)\);')
_RE_KV = re.compile(r'(\w+)\s*=>\s*("[^"]*"|[-\w]+)')

# generic-name aliases between the VHDL and Verilog primitive libraries
_PARAM_ALIASES = {'SUB_OP': 'SUB', 'SHIFT_N': 'SHIFT'}


class VHDLNetlistSim(VerilogNetlistSim):
    def __init__(self, text: str, mem_files: dict[str, str]):
        # bypass the Verilog parser: build structures directly
        self.wire_width = {}
        self.wire_signed = {}
        self.exprs = []
        self.instances = []
        self.mem = {}
        for fname, content in mem_files.items():
            entries: list[int | None] = []
            for line in content.strip().splitlines():
                line = line.strip()
                entries.append(None if 'x' in line else int(line, 16))
            self.mem[fname] = entries

        # a regex miss here would silently mask all I/O to zero width —
        # refuse to simulate unparsed ports, like every other construct
        m = re.search(r'inp : in std_logic_vector\((\d+) downto 0\)', text)
        if not m:
            raise ValueError('Unparsed entity ports: no `inp : in std_logic_vector(hi downto 0)` found')
        self.in_width = int(m.group(1)) + 1
        m = re.search(r'out_port : out std_logic_vector\((\d+) downto 0\)', text)
        if not m:
            raise ValueError('Unparsed entity ports: no `out_port : out std_logic_vector(hi downto 0)` found')
        self.out_width = int(m.group(1)) + 1

        body = text[text.index('architecture') :]
        for raw in body.splitlines():
            line = raw.split('--')[0].strip()
            if not line or line in ('begin', 'end architecture;'):
                continue
            ms = _RE_SIG.match(line)
            if ms:
                name, kind, hi = ms.group(1), ms.group(2), int(ms.group(3))
                self.wire_width[name] = hi + 1
                self.wire_signed[name] = kind == 'signed'
                continue
            mi = _RE_INST.match(line)
            if mi:
                prim, generics_s, ports_s = mi.groups()
                params: dict[str, int | str] = {}
                for k, v in _RE_KV.findall(generics_s):
                    k = _PARAM_ALIASES.get(k, k)
                    params[k] = v.strip('"') if v.startswith('"') else int(v)
                ports = {k: v for k, v in _RE_KV.findall(ports_s)}
                self.instances.append(_Instance(prim, params, ports))
                continue
            ma = _RE_ASSIGN.match(line)
            if ma:
                lhs, hi, lo, rhs = ma.groups()
                if lhs == 'out_port':
                    lhs = 'out'
                sl = (int(hi), int(lo)) if hi is not None else None
                self.exprs.append((lhs, sl, rhs.strip()))
                continue
            if line.startswith(('library', 'use', 'entity', 'port', 'inp :', 'out_port :', ');', 'end entity;', 'architecture')):
                continue
            raise ValueError(f'Unparsed VHDL line: {line}')

    # ----------------------------------------------------------- expression

    def _eval_rhs(self, rhs: str, env: dict[str, int]) -> int:
        rhs = rhs.strip()
        m = re.fullmatch(r'(\w+)\((\d+)\s+downto\s+(\d+)\)', rhs)
        if m:
            name, hi, lo = m.group(1), int(m.group(2)), int(m.group(3))
            return (env[name] >> lo) & _mask(hi - lo + 1)
        m = re.fullmatch(r'"([01]+)"', rhs)
        if m:
            return int(m.group(1), 2)
        if rhs == "(others => '0')":
            return 0
        m = re.fullmatch(r'resize\(signed\((\w+)\), (\d+)\)', rhs)
        if m:
            return _sext(env[m.group(1)], self.wire_width[m.group(1)])
        m = re.fullmatch(r'signed\(resize\(unsigned\((\w+)\), (\d+)\)\)', rhs)
        if m:
            return env[m.group(1)] & _mask(self.wire_width[m.group(1)])
        m = re.fullmatch(r"shift_right\(shift_left\((\w+), (\d+)\), (\d+)\) \+ signed'\(\"([01]+)\"\)", rhs)
        if m:
            base = self._signed_value(m.group(1))
            shifted = _shr(base << int(m.group(2)), int(m.group(3)))
            return shifted + _sext(int(m.group(4), 2), len(m.group(4)))
        m = re.fullmatch(r'std_logic_vector\((\w+)\((\d+)\s+downto\s+(\d+)\)\)', rhs)
        if m:
            name, hi, lo = m.group(1), int(m.group(2)), int(m.group(3))
            return (env[name] >> lo) & _mask(hi - lo + 1)
        if re.fullmatch(r'\w+', rhs):
            return env[rhs]
        raise ValueError(f'Unparsed VHDL rhs: {rhs}')


def simulate_comb_vhdl(comb, name: str = 'sim', data: NDArray | None = None) -> NDArray[np.float64]:
    """Emit `comb` to VHDL, simulate the netlist over `data`, return floats."""
    if data is None:  # would otherwise crash deep inside pack_inputs on np.asarray(None)
        raise ValueError('simulate_comb_vhdl requires a (n_samples, n_in) data batch, got None')
    from ..verilog.netlist_sim import run_netlist
    from .comb import VHDLCombEmitter

    em = VHDLCombEmitter(comb, name)
    sim = VHDLNetlistSim(em.emit(), em.mem_files)
    return run_netlist(em, sim, comb, data)


_RE_VTOP_SIG = re.compile(r'signal\s+(\w+)\s*:\s*std_logic_vector\((\d+)\s+downto\s+0\);')
_RE_VTOP_INST = re.compile(r'\w+\s*:\s*entity\s+work\.(\w+)\s+port map\s*\(inp\s*=>\s*(\w+),\s*out_port\s*=>\s*(\w+)\);')
_RE_VTOP_FF = re.compile(r'process\s*\(clk\)\s*begin\s*if\s*rising_edge\(clk\)\s*then\s*(\w+)\s*<=\s*(\w+);\s*end if;\s*end process;')
_RE_VTOP_OUT = re.compile(r'out_port\s*<=\s*(\w+);')


class VHDLPipelineSim(PipelineNetlistSim):
    """Parse + simulate the VHDL pipelined top emitted by emit_pipeline_vhdl."""

    def __init__(self, top_text: str, stage_texts: list[str], mem_files: dict[str, str]):
        stage_sims: dict[str, VHDLNetlistSim] = {}
        for t in stage_texts:
            ename = re.search(r'entity\s+(\w+)\s+is', t).group(1)
            stage_sims[ename] = VHDLNetlistSim(t, mem_files)

        self.aliases, self.insts, self.regs = [], [], {}
        self.out_src = ''
        # a miss here used to fall back to width 0, masking all I/O to zero;
        # unparsed ports must fail loudly like unparsed body lines
        m = re.search(r'inp : in std_logic_vector\((\d+) downto 0\)', top_text)
        if not m:
            raise ValueError('Unparsed VHDL top ports: no `inp : in std_logic_vector(hi downto 0)` found')
        self.in_width = int(m.group(1)) + 1
        m = re.search(r'out_port : out std_logic_vector\((\d+) downto 0\)', top_text)
        if not m:
            raise ValueError('Unparsed VHDL top ports: no `out_port : out std_logic_vector(hi downto 0)` found')
        self.out_width = int(m.group(1)) + 1

        body = top_text[top_text.index('architecture') :]
        for raw in body.splitlines():
            line = raw.split('--')[0].strip()
            if not line or line in ('begin', 'end architecture;') or line.startswith('architecture'):
                continue
            if m := _RE_VTOP_SIG.match(line):
                pass  # width declaration only
            elif m := _RE_VTOP_FF.match(line):
                self.regs[m.group(1)] = m.group(2)
            elif m := _RE_VTOP_INST.match(line):
                self.insts.append((stage_sims[m.group(1)], m.group(2), m.group(3)))
            elif m := _RE_VTOP_OUT.match(line):
                self.out_src = m.group(1)
            else:
                raise ValueError(f'Unparsed VHDL top line: {line}')
        if not self.out_src:
            raise ValueError('pipelined top has no `out_port <= ...`')


def simulate_pipeline_vhdl(pipeline, name: str = 'sim', data: NDArray | None = None, register_layers: int = 1) -> NDArray[np.float64]:
    """Emit `pipeline` to VHDL and stream `data` through the clocked top."""
    if data is None:  # would otherwise crash deep inside pack_inputs on np.asarray(None)
        raise ValueError('simulate_pipeline_vhdl requires a (n_samples, n_in) data batch, got None')
    from ..verilog.netlist_sim import run_pipeline_netlist
    from .comb import VHDLCombEmitter
    from .pipeline import emit_pipeline_vhdl

    top, mem_files, stage_texts = emit_pipeline_vhdl(pipeline, name, register_layers=register_layers)
    sim = VHDLPipelineSim(top, stage_texts, mem_files)
    em_in = VHDLCombEmitter(pipeline.stages[0], f'{name}_s0')
    em_out = VHDLCombEmitter(pipeline.stages[-1], f'{name}_s{len(pipeline.stages) - 1}')
    return run_pipeline_netlist(em_in, em_out, sim, pipeline, data)
