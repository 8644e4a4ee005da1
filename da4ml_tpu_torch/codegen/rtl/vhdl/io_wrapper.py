"""VHDL uniform-lane IO wrapper (twin of verilog/io_wrapper.py).

Counterpart of ``da4ml_tpu/codegen/rtl/vhdl/io_wrapper.py``.
"""

from __future__ import annotations

from ....ir.comb import CombLogic, Pipeline
from ..verilog.io_wrapper import IOMap, hetero_io_map


def emit_io_wrapper_vhdl(model: CombLogic | Pipeline, name: str, inner: str, clocked: bool) -> tuple[str, IOMap, IOMap]:
    in_map = hetero_io_map(model.inp_qint)
    out_map = hetero_io_map(model.out_qint)
    lw_in, lw_out = in_map.lane_width, out_map.lane_width
    packed_in = sum(w for _, w, _, _ in in_map.elems)
    packed_out = sum(w for _, w, _, _ in out_map.elems)

    decls = [
        f'    signal p_in : std_logic_vector({max(packed_in - 1, 0)} downto 0);',
        f'    signal p_out : std_logic_vector({max(packed_out - 1, 0)} downto 0);',
    ]
    stmts = []
    for e, (off, w, _sg, _f) in enumerate(in_map.elems):
        if w == 0:
            continue
        stmts.append(f'    p_in({off + w - 1} downto {off}) <= inp({e * lw_in + w - 1} downto {e * lw_in});')
    port_assoc = 'clk => clk, ' if clocked else ''
    stmts.append(f'    core : entity work.{inner} port map ({port_assoc}inp => p_in, out_port => p_out);')
    for e, (off, w, sg, _f) in enumerate(out_map.elems):
        hi, lo = (e + 1) * lw_out - 1, e * lw_out
        if w == 0:
            stmts.append(f"    out_port({hi} downto {lo}) <= (others => '0');")
        elif w == lw_out:
            stmts.append(f'    out_port({hi} downto {lo}) <= p_out({off + w - 1} downto {off});')
        else:
            fill = f'p_out({off + w - 1})' if sg else "'0'"
            stmts.append(f'    out_port({hi} downto {lo + w}) <= (others => {fill});')
            stmts.append(f'    out_port({lo + w - 1} downto {lo}) <= p_out({off + w - 1} downto {off});')

    clk_port = '        clk : in std_logic;\n' if clocked else ''
    text = '\n'.join(
        [
            f'-- Uniform-lane IO wrapper for {inner}',
            'library ieee;',
            'use ieee.std_logic_1164.all;',
            '',
            f'entity {name} is',
            '    port (',
            clk_port + f'        inp : in std_logic_vector({max(in_map.total_uniform - 1, 0)} downto 0);',
            f'        out_port : out std_logic_vector({max(out_map.total_uniform - 1, 0)} downto 0)',
            '    );',
            'end entity;',
            '',
            f'architecture rtl of {name} is',
            *decls,
            'begin',
            *stmts,
            'end architecture;',
        ]
    )
    return text + '\n', in_map, out_map
