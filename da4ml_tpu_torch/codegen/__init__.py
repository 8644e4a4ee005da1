"""Code generation: RTL (Verilog/VHDL) projects.

Counterpart of ``da4ml_tpu/codegen/``; its HLS flavour (``codegen/hls/``)
is not ported yet.
"""

from .rtl.rtl_model import RTLModel, VerilogModel, VHDLModel

__all__ = ['RTLModel', 'VerilogModel', 'VHDLModel']
