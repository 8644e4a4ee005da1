"""da4ml_tpu_torch — the PyTorch/CUDA port of ``da4ml_tpu``

A second package beside ``da4ml_tpu`` with the same layout (``ir/``,
``ops/``, ``cmvm/``, ``trace/``, ``runtime/``, ``analysis/``, ``codegen/``,
``converter/``). It imports torch and numpy,
never jax and nothing of ``da4ml_tpu``; the modules it needs are its own
copies. Entry points run on the CUDA device unless the caller passes
``device='cpu'``.

The flagship path: trace → CMVM solve (on the host, natively by default,
or by the device search, whose greedy loop is ``csrc/fused_cse.cu``) → DAIS
program → execution by the hand-written CUDA kernel ``csrc/dais_exec.cu``
(``runtime.cuda_backend``). See ``entry.py``. ``native/`` builds the C++ host
library (solver, interpreter, the search's emission) with g++ at first use.
The firmware path: ``converter.trace_model`` turns an ``nn.Module`` into the
trace, and ``codegen.VerilogModel``/``VHDLModel`` write the HDL project once
the verifier (``analysis``) passes the program.
"""

__version__ = '0.1.0'
