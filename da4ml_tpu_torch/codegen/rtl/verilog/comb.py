"""Verilog emitter for one CombLogic stage.

Each live SSA op becomes a wire plus a primitive instantiation (shift_adder /
quantizer / relu / msb_mux / multiplier / lookup_table / bit_binop /
bit_unary / negative from ``source/``); dead ops (ref_count 0) are skipped.
Ports are flat bit vectors packing the heterogeneous per-element fixed-point
formats back to back (LSB first).

Counterpart of ``da4ml_tpu/codegen/rtl/verilog/comb.py``.
"""

from __future__ import annotations

from math import ceil

import numpy as np

from ....ir.comb import CombLogic
from ....ir.types import minimal_kif


def _i32(x: int) -> int:
    return ((int(x) & 0xFFFFFFFF) + (1 << 31)) % (1 << 32) - (1 << 31)


def _hex_entry(value: float, width: int) -> str:
    """One $readmemh entry: two's-complement hex, 'x' for unreachable (NaN)."""
    digits = max(ceil(width / 4), 1)
    if np.isnan(value):
        return 'x' * digits
    return format(int(value) & ((1 << width) - 1), f'0{digits}x')


class VerilogCombEmitter:
    """Emit one combinational module for a CombLogic stage."""

    def __init__(self, comb: CombLogic, name: str, print_latency: bool = False):
        self.comb = comb
        self.name = name
        self.print_latency = print_latency
        self.kifs = [minimal_kif(op.qint) for op in comb.ops]
        self.widths = [k + i + f for k, i, f in self.kifs]
        self.mem_files: dict[str, str] = {}
        self._table_mem: dict[int, str] = {}

    # -------------------------------------------------------------- layout

    def input_layout(self) -> list[tuple[int, int]]:
        """(offset, width) per input index, LSB-first packing."""
        widths = [0] * self.comb.shape[0]
        for n, op in enumerate(self.comb.ops):
            if op.opcode == -1:
                widths[op.id0] = self.widths[n]
        out, off = [], 0
        for w in widths:
            out.append((off, w))
            off += w
        return out

    def output_layout(self) -> list[tuple[int, int]]:
        out, off = [], 0
        for qi in self.comb.out_qint:
            k, i, f = minimal_kif(qi)
            w = k + i + f
            out.append((off, w))
            off += w
        return out

    @property
    def total_in(self) -> int:
        lay = self.input_layout()
        return lay[-1][0] + lay[-1][1] if lay else 0

    @property
    def total_out(self) -> int:
        lay = self.output_layout()
        return lay[-1][0] + lay[-1][1] if lay else 0

    # ------------------------------------------------------------ emission

    def _inst(self, prim: str, n: int, params: dict, ports: dict) -> str:
        p = ', '.join(f'.{k}({v})' for k, v in params.items())
        io = ', '.join(f'.{k}({v})' for k, v in ports.items())
        lat = f'  // latency={self.comb.ops[n].latency}' if self.print_latency else ''
        return f'    {prim} #({p}) i{n} ({io});{lat}'

    def _op_lines(self, n: int, rc) -> list[str]:
        comb, op = self.comb, self.comb.ops[n]
        oc = op.opcode
        k, i, f = self.kifs[n]
        w = self.widths[n]
        if w == 0:
            return [f'    wire v{n}_zero = 1\'b0;']  # zero-width value, never read as data
        decl = f'    wire [{w - 1}:0] v{n};'
        lines = [decl]

        def kw(idx):  # (signed, width, frac) of an operand
            kk, ii, ff = self.kifs[idx]
            return int(kk), self.widths[idx], ff

        if oc == -1:
            off, width = self.input_layout()[op.id0]
            lines.append(f'    assign v{n} = inp[{off + width - 1}:{off}];')
        elif oc in (0, 1):
            s0, w0, f0 = kw(op.id0)
            s1, w1, f1 = kw(op.id1)
            s = int(op.data) + f0 - f1
            gshift = max(max(f0, f1 - int(op.data)) - f, 0)
            lines.append(
                self._inst(
                    'shift_adder',
                    n,
                    dict(WA=w0, SA=s0, WB=w1, SB=s1, SHA=max(-s, 0), SHB=max(s, 0), SUB=int(oc == 1), GSHIFT=gshift, WO=w),
                    dict(a=f'v{op.id0}', b=f'v{op.id1}', o=f'v{n}'),
                )
            )
        elif oc in (2, -2):
            s0, w0, f0 = kw(op.id0)
            lines.append(
                self._inst(
                    'relu',
                    n,
                    dict(WA=w0, SA=s0, NEG=int(oc == -2), SHIFT=f - f0, WO=w),
                    dict(a=f'v{op.id0}', o=f'v{n}'),
                )
            )
        elif oc in (3, -3):
            s0, w0, f0 = kw(op.id0)
            lines.append(
                self._inst(
                    'quantizer',
                    n,
                    dict(WA=w0, SA=s0, NEG=int(oc == -3), SHIFT=f - f0, WO=w),
                    dict(a=f'v{op.id0}', o=f'v{n}'),
                )
            )
        elif oc == 4:
            s0, w0, f0 = kw(op.id0)
            shift = f - f0
            shl, shr = max(shift, 0), max(-shift, 0)
            wi = max(w0, w + shr) + shl + 2
            c = int(op.data)
            lit = f"-{wi}'sd{-c}" if c < 0 else f"{wi}'sd{c}"
            ext = f'$signed(v{op.id0})' if s0 else f"$signed({{1'b0, v{op.id0}}})"
            lines.append(f'    wire signed [{wi - 1}:0] ca{n} = {ext};')
            lines.append(f'    wire signed [{wi - 1}:0] cr{n} = ((ca{n} <<< {shl}) >>> {shr}) + {lit};')
            lines.append(f'    assign v{n} = cr{n}[{w - 1}:0];')
        elif oc == 5:
            c = int(op.data) & ((1 << w) - 1)
            lines.append(f"    assign v{n} = {w}'d{c};")
        elif oc in (6, -6):
            ic = int(op.data) & 0xFFFFFFFF
            dhi = _i32(int(op.data) >> 32)
            sc, wc, _ = kw(ic)
            s0, w0, f0 = kw(op.id0)
            s1, w1, f1 = kw(op.id1)
            lines.append(
                self._inst(
                    'msb_mux',
                    n,
                    dict(
                        WC=wc,
                        WA=w0,
                        SA=s0,
                        WB=w1,
                        SB=s1,
                        NEG_B=int(oc == -6),
                        SH0=f - f0,
                        SH1=f - f1 + dhi,
                        WO=w,
                    ),
                    dict(c=f'v{ic}', a=f'v{op.id0}', b=f'v{op.id1}', o=f'v{n}'),
                )
            )
        elif oc == 7:
            s0, w0, _ = kw(op.id0)
            s1, w1, _ = kw(op.id1)
            lines.append(
                self._inst(
                    'multiplier',
                    n,
                    dict(WA=w0, SA=s0, WB=w1, SB=s1, WO=w),
                    dict(a=f'v{op.id0}', b=f'v{op.id1}', o=f'v{n}'),
                )
            )
        elif oc == 8:
            assert comb.lookup_tables is not None
            table = comb.lookup_tables[int(op.data)]
            _, w0, _ = kw(op.id0)
            memfile = self._table_memfile(int(op.data), op.id0, w)
            lines.append(
                self._inst(
                    'lookup_table',
                    n,
                    dict(WA=w0, WO=w, MEMFILE=f'"{memfile}"'),
                    dict(a=f'v{op.id0}', o=f'v{n}'),
                )
            )
        elif oc in (9, -9):
            s0, w0, _ = kw(op.id0)
            lines.append(
                self._inst(
                    'bit_unary',
                    n,
                    dict(WA=w0, SA=s0, W0=w0, NEG=int(oc == -9), OP=int(op.data), WO=w),
                    dict(a=f'v{op.id0}', o=f'v{n}'),
                )
            )
        elif oc == 10:
            s0, w0, f0 = kw(op.id0)
            s1, w1, f1 = kw(op.id1)
            data = int(op.data)
            shift = _i32(data) + f0 - f1
            subop = (data >> 56) & 0xFF
            lines.append(
                self._inst(
                    'bit_binop',
                    n,
                    dict(
                        WA=w0,
                        SA=s0,
                        WB=w1,
                        SB=s1,
                        NEG_A=(data >> 32) & 1,
                        NEG_B=(data >> 33) & 1,
                        SHA=max(-shift, 0),
                        SHB=max(shift, 0),
                        OP=subop,
                        WO=w,
                    ),
                    dict(a=f'v{op.id0}', b=f'v{op.id1}', o=f'v{n}'),
                )
            )
        else:
            raise ValueError(f'Unknown opcode {oc} in op {n}')
        return lines

    def _table_memfile(self, t_idx: int, key_op: int, out_width: int) -> str:
        if t_idx in self._table_mem:
            return self._table_mem[t_idx]
        assert self.comb.lookup_tables is not None
        table = self.comb.lookup_tables[t_idx]
        key_qint = self.comb.ops[key_op].qint
        padded = table.padded_table(key_qint)
        fname = f'lut_{table.spec.hash[:16]}.mem'
        self.mem_files[fname] = '\n'.join(_hex_entry(v, out_width) for v in padded) + '\n'
        self._table_mem[t_idx] = fname
        return fname

    def emit(self) -> str:
        comb = self.comb
        rc = comb.ref_count
        lines = [
            f'// Generated by da4ml_tpu: combinational DAIS stage {self.name}',
            f'module {self.name} (',
            f'    input  [{max(self.total_in - 1, 0)}:0] inp,',
            f'    output [{max(self.total_out - 1, 0)}:0] out',
            ');',
        ]
        for n in range(len(comb.ops)):
            if rc[n] == 0:
                continue
            lines.extend(self._op_lines(n, rc))

        out_lay = self.output_layout()
        neg_emitted: dict[int, str] = {}
        for j, (idx, neg) in enumerate(zip(comb.out_idxs, comb.out_negs)):
            off, w = out_lay[j]
            if w == 0:
                continue
            sl = f'out[{off + w - 1}:{off}]'
            if idx < 0 or self.widths[idx] == 0:
                lines.append(f"    assign {sl} = {w}'d0;")
                continue
            if not neg:
                assert w == self.widths[idx], f'output {j}: width {w} != op width {self.widths[idx]}'
                lines.append(f'    assign {sl} = v{idx};')
            else:
                if idx not in neg_emitted:
                    k0, _, _ = self.kifs[idx]
                    lines.append(f'    wire [{w - 1}:0] vneg{idx};')
                    lines.append(
                        self._inst(
                            'negative',
                            len(comb.ops) + j,
                            dict(WA=self.widths[idx], SA=int(k0), WO=w),
                            dict(a=f'v{idx}', o=f'vneg{idx}'),
                        )
                    )
                    neg_emitted[idx] = f'vneg{idx}'
                lines.append(f'    assign {sl} = {neg_emitted[idx]};')
        lines.append('endmodule')
        return '\n'.join(lines) + '\n'
