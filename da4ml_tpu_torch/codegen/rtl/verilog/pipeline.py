"""Verilog top-level emitter for a Pipeline: stage modules + inter-stage
registers (II=1), with optional extra register layers for retiming slack.

Counterpart of ``da4ml_tpu/codegen/rtl/verilog/pipeline.py``.
"""

from __future__ import annotations

from ....ir.comb import Pipeline
from .comb import VerilogCombEmitter


def emit_pipeline(
    pipeline: Pipeline,
    name: str,
    print_latency: bool = False,
    register_layers: int = 1,
) -> tuple[str, dict[str, str], list[str]]:
    """Returns (top_module_text, mem_files, stage_module_texts)."""
    stage_texts: list[str] = []
    mem_files: dict[str, str] = {}
    emitters: list[VerilogCombEmitter] = []
    for si, stage in enumerate(pipeline.stages):
        em = VerilogCombEmitter(stage, f'{name}_s{si}', print_latency=print_latency)
        stage_texts.append(em.emit())
        mem_files.update(em.mem_files)
        emitters.append(em)

    n_stages = len(pipeline.stages)
    total_in = emitters[0].total_in
    total_out = emitters[-1].total_out

    lines = [
        f'// Generated by da4ml_tpu: II=1 pipeline {name} ({n_stages} stages)',
        f'module {name} (',
        '    input clk,',
        f'    input  [{max(total_in - 1, 0)}:0] inp,',
        f'    output [{max(total_out - 1, 0)}:0] out',
        ');',
    ]
    prev = 'inp'
    for si, em in enumerate(emitters):
        wi, wo = em.total_in, em.total_out
        lines.append(f'    wire [{max(wi - 1, 0)}:0] s{si}_in = {prev};')
        lines.append(f'    wire [{max(wo - 1, 0)}:0] s{si}_out;')
        lines.append(f'    {name}_s{si} u{si} (.inp(s{si}_in), .out(s{si}_out));')
        if si < n_stages - 1:
            src = f's{si}_out'
            for layer in range(max(register_layers, 1)):
                reg = f's{si}_r{layer}'
                lines.append(f'    reg [{max(wo - 1, 0)}:0] {reg};')
                lines.append(f'    always @(posedge clk) {reg} <= {src};')
                src = reg
            prev = src
    lines.append(f'    assign out = s{n_stages - 1}_out;')
    lines.append('endmodule')
    return '\n'.join(lines) + '\n', mem_files, stage_texts
