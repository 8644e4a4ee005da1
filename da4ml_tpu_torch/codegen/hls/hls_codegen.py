"""HLS C++ emitter: one straight-line kernel function per CombLogic stage.

Every live SSA op becomes one int64 statement using the ``da::`` helpers
(dais_hls.hh); lookup tables become static const arrays. Pipelines chain
stage functions under ``#pragma HLS dataflow``. The same source compiles
bit-exactly with plain g++ (emulation) and with Vitis HLS (synthesis).

Counterpart of ``da4ml_tpu/codegen/hls/hls_codegen.py``; the emitted text
is the same byte for byte.
"""

from __future__ import annotations

from ...ir.comb import CombLogic, Pipeline
from ...ir.types import minimal_kif


def _i32(x: int) -> int:
    return ((int(x) & 0xFFFFFFFF) + (1 << 31)) % (1 << 32) - (1 << 31)


class HLSCombEmitter:
    """Emit one HLS kernel function for a CombLogic stage."""

    def __init__(self, comb: CombLogic, name: str, print_latency: bool = False, flavor: str = 'vitis'):
        self.comb = comb
        self.name = name
        self.print_latency = print_latency
        self.flavor = flavor
        self.kifs = [minimal_kif(op.qint) for op in comb.ops]
        self.widths = [k + i + f for k, i, f in self.kifs]
        self.tables: dict[int, str] = {}
        self.table_decls: list[str] = []

    def _table_name(self, t_idx: int, key_op: int) -> str:
        if t_idx in self.tables:
            return self.tables[t_idx]
        assert self.comb.lookup_tables is not None
        table = self.comb.lookup_tables[t_idx]
        tname = f'{self.name}_tbl_{table.spec.hash[:12]}'
        vals = ', '.join(str(int(v)) for v in table.table)
        self.table_decls.append(f'static const int64_t {tname}[{len(table.table)}] = {{{vals}}};')
        self.tables[t_idx] = tname
        return tname

    def _op_stmt(self, n: int) -> str:
        comb, op = self.comb, self.comb.ops[n]
        oc = op.opcode
        k, i, f = self.kifs[n]
        sg, w = int(k), self.widths[n]

        def kw(idx):
            kk, ii, ff = self.kifs[idx]
            return int(kk), self.widths[idx], ff

        if oc == -1:
            expr = f'in[{op.id0}]'
        elif oc in (0, 1):
            _, _, f0 = kw(op.id0)
            _, _, f1 = kw(op.id1)
            s = int(op.data) + f0 - f1
            gshift = max(max(f0, f1 - int(op.data)) - f, 0)
            expr = f'da::shift_add(v{op.id0}, v{op.id1}, {int(oc == 1)}, {s}, {gshift})'
        elif oc in (2, -2):
            _, _, f0 = kw(op.id0)
            v = f'-v{op.id0}' if oc == -2 else f'v{op.id0}'
            expr = f'da::relu_q({v}, {f0}, {sg}, {w}, {f})'
        elif oc in (3, -3):
            _, _, f0 = kw(op.id0)
            v = f'-v{op.id0}' if oc == -3 else f'v{op.id0}'
            expr = f'da::requant({v}, {f0}, {sg}, {w}, {f})'
        elif oc == 4:
            _, _, f0 = kw(op.id0)
            expr = f'da::shl(v{op.id0}, {f - f0}) + INT64_C({int(op.data)})'
        elif oc == 5:
            expr = f'INT64_C({int(op.data)})'
        elif oc in (6, -6):
            ic = int(op.data) & 0xFFFFFFFF
            dhi = _i32(int(op.data) >> 32)
            sc, wc, _ = kw(ic)
            _, _, f0 = kw(op.id0)
            _, _, f1 = kw(op.id1)
            v1 = f'-v{op.id1}' if oc == -6 else f'v{op.id1}'
            r0 = f'da::wrap(da::shl(v{op.id0}, {f - f0}), {sg}, {w})'
            r1 = f'da::wrap(da::shl({v1}, {f - f1 + dhi}), {sg}, {w})'
            expr = f'da::msb(v{ic}, {sc}, {wc}) ? {r0} : {r1}'
        elif oc == 7:
            expr = f'v{op.id0} * v{op.id1}'
        elif oc == 8:
            assert comb.lookup_tables is not None
            tname = self._table_name(int(op.data), op.id0)
            table = comb.lookup_tables[int(op.data)]
            sg0, w0, _ = kw(op.id0)
            zero = -(1 << (w0 - 1)) if sg0 else 0
            pad_left = table.pads(comb.ops[op.id0].qint)[0]
            expr = f'{tname}[v{op.id0} - INT64_C({zero + pad_left})]'
        elif oc in (9, -9):
            sg0, w0, _ = kw(op.id0)
            v = f'-v{op.id0}' if oc == -9 else f'v{op.id0}'
            mask = (1 << w0) - 1
            if op.data == 0:
                expr = f'~({v})' if sg else f'(~({v})) & INT64_C({mask})'
            elif op.data == 1:
                expr = f'int64_t(({v}) != 0)'
            elif op.data == 2:
                expr = f'int64_t((({v}) & INT64_C({mask})) == INT64_C({mask}))'
            else:
                raise ValueError(f'Unknown bit unary data {op.data}')
        elif oc == 10:
            _, _, f0 = kw(op.id0)
            _, _, f1 = kw(op.id1)
            data = int(op.data)
            shift = _i32(data) + f0 - f1
            subop = (data >> 56) & 0xFF
            a = f'-v{op.id0}' if (data >> 32) & 1 else f'v{op.id0}'
            b = f'-v{op.id1}' if (data >> 33) & 1 else f'v{op.id1}'
            if shift > 0:
                b = f'da::shl({b}, {shift})'
            elif shift < 0:
                a = f'da::shl({a}, {-shift})'
            sym = {0: '&', 1: '|', 2: '^'}[subop]
            expr = f'({a}) {sym} ({b})'
        else:
            raise ValueError(f'Unknown opcode {oc} in op {n}')

        lat = f'  // latency={op.latency}' if self.print_latency else ''
        wrap_in_entry = oc == -1  # bridge passes pre-wrapped codes
        del wrap_in_entry
        return f'    const int64_t v{n} = {expr};{lat}'

    def emit_function(self) -> str:
        comb = self.comb
        rc = comb.ref_count
        n_in, n_out = comb.shape
        lines = [f'static void {self.name}(const int64_t in[{max(n_in, 1)}], int64_t out[{max(n_out, 1)}]) {{']
        if self.flavor == 'vitis':
            lines += ['#pragma HLS INLINE off', '#pragma HLS PIPELINE II=1']
        # Intel flavors: II is a component-level property (hls_component_ii on
        # the synthesis top, hls_model._write_synth_files), not a body pragma
        # — Intel's `#pragma ii` binds to the loop that follows it, and these
        # bodies are loop-free straight-line code.
        for n in range(len(comb.ops)):
            if rc[n] == 0:
                continue
            lines.append(self._op_stmt(n))
        for j, (idx, neg) in enumerate(zip(comb.out_idxs, comb.out_negs)):
            if idx < 0:
                lines.append(f'    out[{j}] = 0;')
            else:
                v = f'-v{idx}' if neg else f'v{idx}'
                lines.append(f'    out[{j}] = {v};')
        lines.append('}')
        return '\n'.join(lines)


def emit_hls_kernel(model: CombLogic | Pipeline, name: str, print_latency: bool = False, flavor: str = 'vitis') -> str:
    """Emit the full kernel header: helpers include, tables, stage fns, top fn.

    ``flavor`` selects the synthesis-tool dialect of the wrapping only
    (vitis / hlslib / oneapi, reference hls_model.py:45); the kernel body is
    the same explicit int64 integer code for all three, so g++ emulation and
    bit-exactness are flavor-independent.
    """
    stages = model.stages if isinstance(model, Pipeline) else (model,)
    emitters = [HLSCombEmitter(s, f'{name}_s{si}', print_latency, flavor) for si, s in enumerate(stages)]
    fns = [em.emit_function() for em in emitters]

    n_in = stages[0].shape[0]
    n_out = stages[-1].shape[1]
    lines = [
        f'// Generated by da4ml_tpu: HLS kernel {name}',
        '#pragma once',
        '#include <cstdint>',
        '#include "dais_hls.hh"',
        '',
    ]
    for em in emitters:
        lines.extend(em.table_decls)
    lines.append('')
    lines.extend(fns)
    lines.append('')
    lines.append(f'inline void {name}(const int64_t in[{max(n_in, 1)}], int64_t out[{max(n_out, 1)}]) {{')
    if len(stages) > 1 and flavor == 'vitis':
        lines.append('#pragma HLS dataflow')
    buf = 'in'
    for si, stage in enumerate(stages):
        so = stage.shape[1]
        if si < len(stages) - 1:
            lines.append(f'    int64_t b{si}[{max(so, 1)}];')
            lines.append(f'    {name}_s{si}({buf}, b{si});')
            buf = f'b{si}'
        else:
            lines.append(f'    {name}_s{si}({buf}, out);')
    lines.append('}')
    return '\n'.join(lines) + '\n'
