"""VHDL-2008 emitter for one CombLogic stage — structural twin of the
Verilog emitter (same layout, primitives and .mem files; entity
instantiations instead of module instances).

Counterpart of ``da4ml_tpu/codegen/rtl/vhdl/comb.py``.
"""

from __future__ import annotations

from ..verilog.comb import VerilogCombEmitter, _i32


def _bits(value: int, width: int) -> str:
    """Two's-complement binary string literal of `value` in `width` bits."""
    return format(int(value) & ((1 << width) - 1), f'0{width}b')


class VHDLCombEmitter(VerilogCombEmitter):
    """Emit one combinational VHDL entity for a CombLogic stage.

    Reuses the Verilog emitter's layout/table machinery; overrides all text
    generation. Signal declarations are collected separately (VHDL requires
    them in the architecture declarative region).
    """

    def __init__(self, comb, name: str, print_latency: bool = False):
        super().__init__(comb, name, print_latency)
        self._decls: list[str] = []
        self._stmts: list[str] = []

    # ------------------------------------------------------------- helpers

    def _decl_sig(self, name: str, width: int, kind: str = 'std_logic_vector'):
        self._decls.append(f'    signal {name} : {kind}({width - 1} downto 0);')

    def _vinst(self, prim: str, n: int, params: dict, ports: dict):
        g = ', '.join(f'{k} => {v}' for k, v in params.items())
        p = ', '.join(f'{k} => {v}' for k, v in ports.items())
        lat = f'  -- latency={self.comb.ops[n].latency}' if self.print_latency else ''
        self._stmts.append(f'    i{n} : entity work.{prim} generic map ({g}) port map ({p});{lat}')

    def _ext_expr(self, src: str, signed: int, width: int) -> str:
        if signed:
            return f'resize(signed({src}), {width})'
        return f'signed(resize(unsigned({src}), {width}))'

    # ------------------------------------------------------------ op walk

    def _emit_op(self, n: int):
        comb, op = self.comb, self.comb.ops[n]
        oc = op.opcode
        k, i, f = self.kifs[n]
        w = self.widths[n]
        if w == 0:
            return

        def kw(idx):
            kk, ii, ff = self.kifs[idx]
            return int(kk), self.widths[idx], ff

        self._decl_sig(f'v{n}', w)

        if oc == -1:
            off, width = self.input_layout()[op.id0]
            self._stmts.append(f'    v{n} <= inp({off + width - 1} downto {off});')
        elif oc in (0, 1):
            s0, w0, f0 = kw(op.id0)
            s1, w1, f1 = kw(op.id1)
            s = int(op.data) + f0 - f1
            gshift = max(max(f0, f1 - int(op.data)) - f, 0)
            self._vinst(
                'shift_adder',
                n,
                dict(WA=w0, SA=s0, WB=w1, SB=s1, SHA=max(-s, 0), SHB=max(s, 0), SUB_OP=int(oc == 1), GSHIFT=gshift, WO=w),
                dict(a=f'v{op.id0}', b=f'v{op.id1}', o=f'v{n}'),
            )
        elif oc in (2, -2):
            s0, w0, f0 = kw(op.id0)
            self._vinst(
                'relu',
                n,
                dict(WA=w0, SA=s0, NEG=int(oc == -2), SHIFT_N=f - f0, WO=w),
                dict(a=f'v{op.id0}', o=f'v{n}'),
            )
        elif oc in (3, -3):
            s0, w0, f0 = kw(op.id0)
            self._vinst(
                'quantizer',
                n,
                dict(WA=w0, SA=s0, NEG=int(oc == -3), SHIFT_N=f - f0, WO=w),
                dict(a=f'v{op.id0}', o=f'v{n}'),
            )
        elif oc == 4:
            s0, w0, f0 = kw(op.id0)
            shift = f - f0
            shl, shr = max(shift, 0), max(-shift, 0)
            wi = max(w0, w + shr) + shl + 2
            self._decl_sig(f'ca{n}', wi, 'signed')
            self._decl_sig(f'cr{n}', wi, 'signed')
            self._stmts.append(f'    ca{n} <= {self._ext_expr(f"v{op.id0}", s0, wi)};')
            self._stmts.append(
                f'    cr{n} <= shift_right(shift_left(ca{n}, {shl}), {shr}) + signed\'("{_bits(int(op.data), wi)}");'
            )
            self._stmts.append(f'    v{n} <= std_logic_vector(cr{n}({w - 1} downto 0));')
        elif oc == 5:
            self._stmts.append(f'    v{n} <= "{_bits(int(op.data), w)}";')
        elif oc in (6, -6):
            ic = int(op.data) & 0xFFFFFFFF
            dhi = _i32(int(op.data) >> 32)
            sc, wc, _ = kw(ic)
            s0, w0, f0 = kw(op.id0)
            s1, w1, f1 = kw(op.id1)
            self._vinst(
                'msb_mux',
                n,
                dict(WC=wc, WA=w0, SA=s0, WB=w1, SB=s1, NEG_B=int(oc == -6), SH0=f - f0, SH1=f - f1 + dhi, WO=w),
                dict(c=f'v{ic}', a=f'v{op.id0}', b=f'v{op.id1}', o=f'v{n}'),
            )
        elif oc == 7:
            s0, w0, _ = kw(op.id0)
            s1, w1, _ = kw(op.id1)
            self._vinst(
                'multiplier',
                n,
                dict(WA=w0, SA=s0, WB=w1, SB=s1, WO=w),
                dict(a=f'v{op.id0}', b=f'v{op.id1}', o=f'v{n}'),
            )
        elif oc == 8:
            _, w0, _ = kw(op.id0)
            memfile = self._table_memfile(int(op.data), op.id0, w)
            self._vinst(
                'lookup_table',
                n,
                dict(WA=w0, WO=w, MEMFILE=f'"{memfile}"'),
                dict(a=f'v{op.id0}', o=f'v{n}'),
            )
        elif oc in (9, -9):
            s0, w0, _ = kw(op.id0)
            self._vinst(
                'bit_unary',
                n,
                dict(WA=w0, SA=s0, W0=w0, NEG=int(oc == -9), OP=int(op.data), WO=w),
                dict(a=f'v{op.id0}', o=f'v{n}'),
            )
        elif oc == 10:
            s0, w0, f0 = kw(op.id0)
            s1, w1, f1 = kw(op.id1)
            data = int(op.data)
            shift = _i32(data) + f0 - f1
            self._vinst(
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
                    OP=(data >> 56) & 0xFF,
                    WO=w,
                ),
                dict(a=f'v{op.id0}', b=f'v{op.id1}', o=f'v{n}'),
            )
        else:
            raise ValueError(f'Unknown opcode {oc} in op {n}')

    def emit(self) -> str:
        comb = self.comb
        rc = comb.ref_count
        self._decls, self._stmts = [], []
        for n in range(len(comb.ops)):
            if rc[n] == 0:
                continue
            self._emit_op(n)

        out_lay = self.output_layout()
        neg_emitted: dict[tuple[int, int], str] = {}
        for j, (idx, neg) in enumerate(zip(comb.out_idxs, comb.out_negs)):
            off, w = out_lay[j]
            if w == 0:
                continue
            sl = f'out_port({off + w - 1} downto {off})'
            if idx < 0 or self.widths[idx] == 0:
                self._stmts.append(f"    {sl} <= (others => '0');")
                continue
            if not neg:
                self._stmts.append(f'    {sl} <= v{idx};')
            else:
                key = (idx, w)
                if key not in neg_emitted:
                    k0, _, _ = self.kifs[idx]
                    self._decl_sig(f'vneg{idx}_{w}', w)
                    self._vinst(
                        'negative',
                        len(comb.ops) + j,
                        dict(WA=self.widths[idx], SA=int(k0), WO=w),
                        dict(a=f'v{idx}', o=f'vneg{idx}_{w}'),
                    )
                    neg_emitted[key] = f'vneg{idx}_{w}'
                self._stmts.append(f'    {sl} <= {neg_emitted[key]};')

        header = [
            f'-- Generated by da4ml_tpu: combinational DAIS stage {self.name}',
            'library ieee;',
            'use ieee.std_logic_1164.all;',
            'use ieee.numeric_std.all;',
            '',
            f'entity {self.name} is',
            '    port (',
            f'        inp : in std_logic_vector({max(self.total_in - 1, 0)} downto 0);',
            f'        out_port : out std_logic_vector({max(self.total_out - 1, 0)} downto 0)',
            '    );',
            'end entity;',
            '',
            f'architecture rtl of {self.name} is',
        ]
        return '\n'.join(header + self._decls + ['begin'] + self._stmts + ['end architecture;']) + '\n'
