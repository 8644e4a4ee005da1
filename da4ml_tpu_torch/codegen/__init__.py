"""Code generation: RTL (Verilog/VHDL) and HLS C++ projects.

Counterpart of ``da4ml_tpu/codegen/``.
"""

from .hls.hls_model import HLSModel
from .rtl.rtl_model import RTLModel, VerilogModel, VHDLModel

__all__ = ['HLSModel', 'RTLModel', 'VerilogModel', 'VHDLModel']
