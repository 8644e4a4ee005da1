"""Heterogeneous-to-uniform IO mapping and the wrapper module.

``hetero_io_map`` packs per-element fixed-point lanes (k, i, f each) into
uniform max-width lanes with sign/zero extension, so external logic can
address element ``e`` at ``e * lane_width`` without knowing the per-element
formats. Counterpart of ``da4ml_tpu/codegen/rtl/verilog/io_wrapper.py``.
"""

from __future__ import annotations

from dataclasses import dataclass

from ....ir.comb import CombLogic, Pipeline
from ....ir.types import minimal_kif


@dataclass
class IOMap:
    lane_width: int
    # per element: (packed_offset, width, signed, frac)
    elems: list[tuple[int, int, bool, int]]

    @property
    def n_lanes(self) -> int:
        return len(self.elems)

    @property
    def total_uniform(self) -> int:
        return self.lane_width * len(self.elems)


def hetero_io_map(qints) -> IOMap:
    elems, off = [], 0
    lane = 1
    for qi in qints:
        k, i, f = minimal_kif(qi)
        w = k + i + f
        elems.append((off, w, bool(k), f))
        off += w
        lane = max(lane, w)
    return IOMap(lane_width=lane, elems=elems)


def emit_io_wrapper(model: CombLogic | Pipeline, name: str, inner: str, clocked: bool) -> tuple[str, IOMap, IOMap]:
    """Wrapper exposing uniform lanes around the packed inner module."""
    in_map = hetero_io_map(model.inp_qint)
    out_map = hetero_io_map(model.out_qint)
    lw_in, lw_out = in_map.lane_width, out_map.lane_width

    lines = [
        f'// Uniform-lane IO wrapper for {inner}',
        f'module {name} (',
    ]
    if clocked:
        lines.append('    input clk,')
    lines.append(f'    input  [{max(in_map.total_uniform - 1, 0)}:0] inp,')
    lines.append(f'    output [{max(out_map.total_uniform - 1, 0)}:0] out')
    lines.append(');')

    packed_in = sum(w for _, w, _, _ in in_map.elems)
    packed_out = sum(w for _, w, _, _ in out_map.elems)
    lines.append(f'    wire [{max(packed_in - 1, 0)}:0] p_in;')
    lines.append(f'    wire [{max(packed_out - 1, 0)}:0] p_out;')
    for e, (off, w, _sg, _f) in enumerate(in_map.elems):
        if w == 0:
            continue
        lines.append(f'    assign p_in[{off + w - 1}:{off}] = inp[{e * lw_in + w - 1}:{e * lw_in}];')
    ports = '.clk(clk), ' if clocked else ''
    lines.append(f'    {inner} core ({ports}.inp(p_in), .out(p_out));')
    for e, (off, w, sg, _f) in enumerate(out_map.elems):
        hi, lo = (e + 1) * lw_out - 1, e * lw_out
        if w == 0:
            lines.append(f"    assign out[{hi}:{lo}] = {lw_out}'d0;")
        elif w == lw_out:
            lines.append(f'    assign out[{hi}:{lo}] = p_out[{off + w - 1}:{off}];')
        else:
            ext = f'{{{lw_out - w}{{p_out[{off + w - 1}]}}}}' if sg else f"{{{lw_out - w}{{1'b0}}}}"
            lines.append(f'    assign out[{hi}:{lo}] = {{{ext}, p_out[{off + w - 1}:{off}]}};')
    lines.append('endmodule')
    return '\n'.join(lines) + '\n', in_map, out_map
