"""VHDL top-level emitter for a Pipeline (II=1 inter-stage registers).

Counterpart of ``da4ml_tpu/codegen/rtl/vhdl/pipeline.py``.
"""

from __future__ import annotations

from ....ir.comb import Pipeline
from .comb import VHDLCombEmitter


def emit_pipeline_vhdl(
    pipeline: Pipeline,
    name: str,
    print_latency: bool = False,
    register_layers: int = 1,
) -> tuple[str, dict[str, str], list[str]]:
    """Returns (top_text, mem_files, stage_texts)."""
    stage_texts: list[str] = []
    mem_files: dict[str, str] = {}
    emitters: list[VHDLCombEmitter] = []
    for si, stage in enumerate(pipeline.stages):
        em = VHDLCombEmitter(stage, f'{name}_s{si}', print_latency=print_latency)
        stage_texts.append(em.emit())
        mem_files.update(em.mem_files)
        emitters.append(em)

    n_stages = len(pipeline.stages)
    total_in = emitters[0].total_in
    total_out = emitters[-1].total_out

    decls, stmts = [], []
    prev = 'inp'
    for si, em in enumerate(emitters):
        wo = em.total_out
        decls.append(f'    signal s{si}_out : std_logic_vector({max(wo - 1, 0)} downto 0);')
        stmts.append(f'    u{si} : entity work.{name}_s{si} port map (inp => {prev}, out_port => s{si}_out);')
        if si < n_stages - 1:
            src = f's{si}_out'
            for layer in range(max(register_layers, 1)):
                reg = f's{si}_r{layer}'
                decls.append(f'    signal {reg} : std_logic_vector({max(wo - 1, 0)} downto 0);')
                stmts.append(f'    process (clk) begin if rising_edge(clk) then {reg} <= {src}; end if; end process;')
                src = reg
            prev = src
    stmts.append(f'    out_port <= s{n_stages - 1}_out;')

    top = '\n'.join(
        [
            f'-- Generated by da4ml_tpu: II=1 pipeline {name} ({n_stages} stages)',
            'library ieee;',
            'use ieee.std_logic_1164.all;',
            '',
            f'entity {name} is',
            '    port (',
            '        clk : in std_logic;',
            f'        inp : in std_logic_vector({max(total_in - 1, 0)} downto 0);',
            f'        out_port : out std_logic_vector({max(total_out - 1, 0)} downto 0)',
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
    return top + '\n', mem_files, stage_texts
