"""Bit-exact netlist simulator for the emitted Verilog subset.

Parses the text produced by :class:`VerilogCombEmitter` (wire declarations,
assigns with slices, primitive instantiations, $readmemh tables) and evaluates
it sample by sample with two's-complement integer semantics. This provides a
true generated-code oracle on hosts without verilator/ghdl: the simulator
executes the emitted netlist, not the IR it came from.

Primitive semantics mirror the modules in ``source/*.v`` bit for bit.

Counterpart of ``da4ml_tpu/codegen/rtl/verilog/netlist_sim.py``.
"""

from __future__ import annotations

import re

import numpy as np
from numpy.typing import NDArray


def _mask(w: int) -> int:
    return (1 << w) - 1


def _sext(v: int, w: int) -> int:
    v &= _mask(w)
    return v - (1 << w) if w > 0 and (v >> (w - 1)) & 1 else v


def _shr(v: int, s: int) -> int:
    return v >> s  # python >> is arithmetic on ints


class _Instance:
    def __init__(self, prim: str, params: dict[str, int | str], ports: dict[str, str]):
        self.prim = prim
        self.params = params
        self.ports = ports


_RE_WIRE = re.compile(r'wire\s+(signed\s+)?\[(\d+):0\]\s+(\w+)\s*(?:=\s*(.+?))?;')
_RE_WIRE1 = re.compile(r'wire\s+(\w+)\s*=\s*(.+?);')
_RE_ASSIGN = re.compile(r'assign\s+(\w+)(?:\[(\d+):(\d+)\])?\s*=\s*(.+?);')
_RE_INST = re.compile(r'(\w+)\s*#\((.*?)\)\s*(\w+)\s*\((.*?)\);')
_RE_KV = re.compile(r'\.(\w+)\(([^()]*(?:\([^()]*\))?[^()]*)\)')


class VerilogNetlistSim:
    """Simulate one emitted combinational module."""

    def __init__(self, text: str, mem_files: dict[str, str]):
        self.wire_width: dict[str, int] = {}
        self.wire_signed: dict[str, bool] = {}
        self.exprs: list[tuple[str, tuple[int, int] | None, str]] = []  # (lhs, slice, rhs)
        self.instances: list[_Instance] = []
        self.mem: dict[str, list[int | None]] = {}
        for fname, content in mem_files.items():
            entries: list[int | None] = []
            for line in content.strip().splitlines():
                line = line.strip()
                entries.append(None if 'x' in line else int(line, 16))
            self.mem[fname] = entries

        # a regex miss here would silently mask all I/O to zero width —
        # refuse to simulate unparsed ports, like every other construct
        m = re.search(r'input\s+\[(\d+):0\]\s+inp', text)
        if not m:
            raise ValueError('Unparsed module ports: no `input [hi:0] inp` declaration found')
        self.in_width = int(m.group(1)) + 1
        m = re.search(r'output\s+\[(\d+):0\]\s+out', text)
        if not m:
            raise ValueError('Unparsed module ports: no `output [hi:0] out` declaration found')
        self.out_width = int(m.group(1)) + 1

        body = text[text.index(');') + 2 :]
        for raw in body.splitlines():
            line = raw.split('//')[0].strip()
            if not line or line == 'endmodule':
                continue
            if line.startswith('wire'):
                mw = _RE_WIRE.match(line)
                if mw:
                    signed, hi, name, rhs = mw.group(1), int(mw.group(2)), mw.group(3), mw.group(4)
                    self.wire_width[name] = hi + 1
                    self.wire_signed[name] = bool(signed)
                    if rhs:
                        self.exprs.append((name, None, rhs.strip()))
                    continue
                m1 = _RE_WIRE1.match(line)
                if m1:
                    self.wire_width[m1.group(1)] = 1
                    self.wire_signed[m1.group(1)] = False
                    self.exprs.append((m1.group(1), None, m1.group(2).strip()))
                    continue
                raise ValueError(f'Unparsed wire: {line}')
            if line.startswith('assign'):
                ma = _RE_ASSIGN.match(line)
                if not ma:
                    raise ValueError(f'Unparsed assign: {line}')
                lhs, hi, lo, rhs = ma.groups()
                sl = (int(hi), int(lo)) if hi is not None else None
                self.exprs.append((lhs, sl, rhs.strip()))
                continue
            mi = _RE_INST.match(line)
            if mi:
                prim, params_s, _iname, ports_s = mi.groups()
                params: dict[str, int | str] = {}
                for k, v in _RE_KV.findall(params_s):
                    v = v.strip()
                    params[k] = v.strip('"') if v.startswith('"') else int(v)
                ports = {k: v.strip() for k, v in _RE_KV.findall(ports_s)}
                self.instances.append(_Instance(prim, params, ports))
                continue
            raise ValueError(f'Unparsed line: {line}')

    # ------------------------------------------------------------- evaluate

    def _eval_rhs(self, rhs: str, env: dict[str, int]) -> int:
        rhs = rhs.strip()
        m = re.fullmatch(r'(\w+)\[(\d+):(\d+)\]', rhs)
        if m:
            name, hi, lo = m.group(1), int(m.group(2)), int(m.group(3))
            v = env[name] if name != 'inp' else env['inp']
            return (v >> lo) & _mask(hi - lo + 1)
        m = re.fullmatch(r"(\d+)'s?d(\d+)", rhs)
        if m:
            return int(m.group(2)) & _mask(int(m.group(1)))
        m = re.fullmatch(r"1'b([01])", rhs)
        if m:
            return int(m.group(1))
        m = re.fullmatch(r"-(\d+)'sd(\d+)", rhs)
        if m:
            return -int(m.group(2))
        m = re.fullmatch(r'\$signed\((\w+)\)', rhs)
        if m:
            name = m.group(1)
            return _sext(env[name], self.wire_width[name])
        m = re.fullmatch(r"\$signed\(\{1'b0, (\w+)\}\)", rhs)
        if m:
            return env[m.group(1)] & _mask(self.wire_width[m.group(1)])
        m = re.fullmatch(r'\(\((\w+) <<< (\d+)\) >>> (\d+)\) \+ (.+)', rhs)
        if m:
            base = self._signed_value(m.group(1))
            shifted = _shr(base << int(m.group(2)), int(m.group(3)))
            return shifted + self._eval_rhs(m.group(4), {**self._env, **{}})
        if re.fullmatch(r'\w+', rhs):
            return self._env[rhs] if rhs in self._env else env[rhs]
        raise ValueError(f'Unparsed rhs: {rhs}')

    def _signed_value(self, name: str) -> int:
        v = self._env[name]
        w = self.wire_width[name]
        return _sext(v, w) if self.wire_signed.get(name, False) else v

    def run_sample(self, inp_bits: int) -> int:
        env: dict[str, int] = {'inp': inp_bits}
        self._env = env
        out_val = 0

        # exprs and instances are interleaved in the source and reference only
        # earlier wires; iterate to a fixed point, deferring entries whose
        # operands aren't computed yet (KeyError)
        pending = [('expr', e) for e in self.exprs] + [('inst', i) for i in self.instances]
        max_rounds = len(pending) + 2
        for _ in range(max_rounds):
            if not pending:
                break
            next_pending = []
            for kind, item in pending:
                try:
                    if kind == 'expr':
                        lhs, sl, rhs = item
                        val = self._eval_rhs(rhs, env)
                        if lhs == 'out':
                            hi, lo = sl if sl else (self.out_width - 1, 0)
                            w = hi - lo + 1
                            out_val |= (val & _mask(w)) << lo
                        else:
                            w = self.wire_width.get(lhs, 64)
                            env[lhs] = val & _mask(w)
                    else:
                        self._run_instance(item, env)
                except KeyError:
                    next_pending.append((kind, item))
            pending = next_pending
        if pending:
            raise RuntimeError(f'Unresolved netlist elements: {pending[:3]}')
        return out_val

    def _run_instance(self, inst: _Instance, env: dict[str, int]):
        p = inst.params
        g = lambda name: env[inst.ports[name]]  # raises KeyError if not ready

        def sval(name, w, signed):
            return _sext(env[inst.ports[name]], w) if signed else env[inst.ports[name]] & _mask(w)

        prim = inst.prim
        if prim == 'shift_adder':
            a = sval('a', p['WA'], p['SA'])
            b = sval('b', p['WB'], p['SB'])
            s = (a << p['SHA']) - (b << p['SHB']) if p['SUB'] else (a << p['SHA']) + (b << p['SHB'])
            r = _shr(s, p['GSHIFT'])
        elif prim == 'negative':
            r = -sval('a', p['WA'], p['SA'])
        elif prim == 'quantizer':
            v = sval('a', p['WA'], p['SA'])
            if p['NEG']:
                v = -v
            sh = p['SHIFT']
            r = v << sh if sh >= 0 else _shr(v, -sh)
        elif prim == 'relu':
            v = sval('a', p['WA'], p['SA'])
            if p['NEG']:
                v = -v
            sh = p['SHIFT']
            q = v << sh if sh >= 0 else _shr(v, -sh)
            r = 0 if v < 0 else q
        elif prim == 'msb_mux':
            c = env[inst.ports['c']]
            sel = (c >> (p['WC'] - 1)) & 1
            a = sval('a', p['WA'], p['SA'])
            b = sval('b', p['WB'], p['SB'])
            if p['NEG_B']:
                b = -b
            r0 = a << p['SH0'] if p['SH0'] >= 0 else _shr(a, -p['SH0'])
            r1 = b << p['SH1'] if p['SH1'] >= 0 else _shr(b, -p['SH1'])
            r = r0 if sel else r1
        elif prim == 'multiplier':
            r = sval('a', p['WA'], p['SA']) * sval('b', p['WB'], p['SB'])
        elif prim == 'lookup_table':
            addr = env[inst.ports['a']] & _mask(p['WA'])
            table = self.mem[str(p['MEMFILE'])]
            entry = table[addr]
            if entry is None:
                raise RuntimeError(f'lookup hit unreachable entry {addr}')
            r = entry
        elif prim == 'bit_unary':
            v = sval('a', p['WA'], p['SA'])
            if p['NEG']:
                v = -v
            vw = v & _mask(p['W0'])
            if p['OP'] == 0:
                r = ~v
            elif p['OP'] == 1:
                r = int(vw != 0)
            else:
                r = int(vw == _mask(p['W0']))
        elif prim == 'bit_binop':
            a = sval('a', p['WA'], p['SA'])
            b = sval('b', p['WB'], p['SB'])
            if p['NEG_A']:
                a = -a
            if p['NEG_B']:
                b = -b
            a <<= p['SHA']
            b <<= p['SHB']
            r = a & b if p['OP'] == 0 else (a | b if p['OP'] == 1 else a ^ b)
        else:
            raise ValueError(f'Unknown primitive {prim}')
        env[inst.ports['o']] = r & _mask(p['WO'])


def pack_inputs(in_lay, comb, data: NDArray) -> list[int]:
    """Pack float samples into the wrapper's input bit lanes."""
    from ....ir.types import minimal_kif

    inp_kifs = [minimal_kif(q) for q in comb.inp_qint]
    packed: list[int] = []
    for row in np.asarray(data, dtype=np.float64):
        bits = 0
        for e, (off, w) in enumerate(in_lay):
            if w == 0:
                continue
            k, i, f = inp_kifs[e]
            v = int(np.floor(row[e] * 2.0 ** (f + int(comb.inp_shifts[e]))))
            bits |= (v & _mask(w)) << off
        packed.append(bits)
    return packed


def descale_outputs(out_lay, comb, out_bits_seq) -> NDArray[np.float64]:
    """Unpack raw output bits into floats, same interpretation as predict."""
    from ....ir.types import minimal_kif

    out_kifs = [minimal_kif(q) for q in comb.out_qint]
    out = np.zeros((len(out_bits_seq), comb.shape[1]), dtype=np.float64)
    for s, out_bits in enumerate(out_bits_seq):
        for e, (off, w) in enumerate(out_lay):
            if w == 0:
                continue
            k, i, f = out_kifs[e]
            raw = (out_bits >> off) & _mask(w)
            out[s, e] = float(_sext(raw, w) if k else raw) * 2.0**-f
    return out


def run_netlist(em, sim, comb, data: NDArray) -> NDArray[np.float64]:
    """Pack samples into wrapper bit lanes, run `sim`, descale the outputs.

    Shared by the Verilog and VHDL flavors; the returned values use the same
    output interpretation as ``CombLogic.predict``, so results are directly
    comparable.
    """
    packed = pack_inputs(em.input_layout(), comb, data)
    out_bits = [sim.run_sample(bits) for bits in packed]
    return descale_outputs(em.output_layout(), comb, out_bits)


class PipelineNetlistSim:
    """Clock-accurate simulator for the emitted II=1 pipelined top module.

    Executes the registered *top-module text* — stage instances evaluate
    through the per-stage netlist simulators, and the `always @(posedge clk)`
    (resp. ``rising_edge(clk)``) registers latch with nonblocking semantics.
    One new sample is fed every clock (II=1) and outputs are read after the
    pipeline's register latency, mirroring the clocked `_inference` loop of
    the project's Verilator binder (``RTLModel._write_binder``).

    The parsed structure is flavor-agnostic: subclasses fill ``aliases``
    (continuous lhs = src), ``insts`` [(stage_sim, in_wire, out_wire)],
    ``regs`` {reg: src}, and ``out_src``.
    """

    aliases: list[tuple[str, str]]
    insts: list[tuple[VerilogNetlistSim, str, str]]
    regs: dict[str, str]
    out_src: str
    in_width: int
    out_width: int

    @property
    def latency_ticks(self) -> int:
        """Clock cycles from a sample entering to its result on `out`."""
        return len(self.regs)

    def _settle(self, env: dict[str, int]) -> None:
        pending = [('alias', a) for a in self.aliases] + [('inst', i) for i in self.insts]
        for _ in range(len(pending) + 2):
            if not pending:
                return
            nxt = []
            for kind, item in pending:
                try:
                    if kind == 'alias':
                        lhs, src = item
                        env[lhs] = env[src]
                    else:
                        sim, iw, ow = item
                        env[ow] = sim.run_sample(env[iw])
                except KeyError:
                    nxt.append((kind, item))
            pending = nxt
        if pending:
            raise RuntimeError(f'Unresolved top-module elements: {pending[:3]}')

    def run_stream(self, samples: list[int]) -> list[int]:
        """Feed one sample per rising edge; return one output per sample."""
        regs = dict.fromkeys(self.regs, 0)
        lat = self.latency_ticks
        outs: list[int] = []
        for t in range(len(samples) + lat):
            env = dict(regs)
            env['inp'] = (samples[t] & _mask(self.in_width)) if t < len(samples) else 0
            self._settle(env)
            if t >= lat:
                outs.append(env[self.out_src] & _mask(self.out_width))
            # nonblocking: every register samples its source from this cycle
            regs = {r: env[src] for r, src in self.regs.items()}
        return outs


_RE_TOP_ALIAS = re.compile(r'wire\s+\[(\d+):0\]\s+(\w+)\s*=\s*(\w+);')
_RE_TOP_DECL = re.compile(r'(?:wire|reg)\s+\[(\d+):0\]\s+(\w+);')
_RE_TOP_FF = re.compile(r'always\s*@\(posedge clk\)\s+(\w+)\s*<=\s*(\w+);')
_RE_TOP_INST = re.compile(r'(\w+)\s+(\w+)\s*\(\s*\.inp\((\w+)\),\s*\.out\((\w+)\)\s*\);')
_RE_TOP_OUT = re.compile(r'assign\s+out\s*=\s*(\w+);')


class VerilogPipelineSim(PipelineNetlistSim):
    """Parse + simulate the Verilog pipelined top emitted by emit_pipeline."""

    def __init__(self, top_text: str, stage_texts: list[str], mem_files: dict[str, str]):
        stage_sims: dict[str, VerilogNetlistSim] = {}
        for t in stage_texts:
            mname = re.search(r'module\s+(\w+)', t).group(1)
            stage_sims[mname] = VerilogNetlistSim(t, mem_files)

        self.aliases, self.insts, self.regs = [], [], {}
        self.out_src = ''
        # a miss here used to fall back to width 0, masking all I/O to zero;
        # unparsed ports must fail loudly like unparsed body lines
        m = re.search(r'input\s+\[(\d+):0\]\s+inp', top_text)
        if not m:
            raise ValueError('Unparsed pipelined top ports: no `input [hi:0] inp` declaration found')
        self.in_width = int(m.group(1)) + 1
        m = re.search(r'output\s+\[(\d+):0\]\s+out', top_text)
        if not m:
            raise ValueError('Unparsed pipelined top ports: no `output [hi:0] out` declaration found')
        self.out_width = int(m.group(1)) + 1

        body = top_text[top_text.index(');') + 2 :]
        for raw in body.splitlines():
            line = raw.split('//')[0].strip()
            if not line or line == 'endmodule':
                continue
            if m := _RE_TOP_ALIAS.match(line):
                self.aliases.append((m.group(2), m.group(3)))
            elif _RE_TOP_DECL.match(line):
                pass  # width declaration only
            elif m := _RE_TOP_FF.match(line):
                self.regs[m.group(1)] = m.group(2)
            elif m := _RE_TOP_INST.match(line):
                self.insts.append((stage_sims[m.group(1)], m.group(3), m.group(4)))
            elif m := _RE_TOP_OUT.match(line):
                self.out_src = m.group(1)
            else:
                raise ValueError(f'Unparsed top-module line: {line}')
        if not self.out_src:
            raise ValueError('pipelined top has no `assign out = ...`')


def run_pipeline_netlist(em_in, em_out, sim, pipeline, data: NDArray) -> NDArray[np.float64]:
    """Pack `data`, stream it through the clocked top `sim`, descale.

    Shared by the Verilog and VHDL flavors (the streaming analog of
    ``run_netlist``). Returns floats with the same interpretation as
    ``Pipeline``-replay / ``CombLogic.predict``.
    """
    packed = pack_inputs(em_in.input_layout(), pipeline, data)
    out_bits = sim.run_stream(packed)
    return descale_outputs(em_out.output_layout(), pipeline, out_bits)


def simulate_pipeline(pipeline, name: str = 'sim', data: NDArray | None = None, register_layers: int = 1) -> NDArray[np.float64]:
    """Emit `pipeline` to Verilog and stream `data` through the clocked top."""
    if data is None:  # would otherwise crash deep inside pack_inputs on np.asarray(None)
        raise ValueError('simulate_pipeline requires a (n_samples, n_in) data batch, got None')
    from .comb import VerilogCombEmitter
    from .pipeline import emit_pipeline

    top, mem_files, stage_texts = emit_pipeline(pipeline, name, register_layers=register_layers)
    sim = VerilogPipelineSim(top, stage_texts, mem_files)
    em_in = VerilogCombEmitter(pipeline.stages[0], f'{name}_s0')
    em_out = VerilogCombEmitter(pipeline.stages[-1], f'{name}_s{len(pipeline.stages) - 1}')
    return run_pipeline_netlist(em_in, em_out, sim, pipeline, data)


def simulate_comb(comb, name: str = 'sim', data: NDArray | None = None) -> NDArray[np.float64]:
    """Emit `comb` to Verilog, simulate the netlist over `data`, return floats."""
    if data is None:  # would otherwise crash deep inside pack_inputs on np.asarray(None)
        raise ValueError('simulate_comb requires a (n_samples, n_in) data batch, got None')
    from .comb import VerilogCombEmitter

    em = VerilogCombEmitter(comb, name)
    sim = VerilogNetlistSim(em.emit(), em.mem_files)
    return run_netlist(em, sim, comb, data)
