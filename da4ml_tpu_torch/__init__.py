"""da4ml_tpu_torch — the PyTorch/CUDA port of ``da4ml_tpu``

A second package beside ``da4ml_tpu`` with the same layout (``ir/``,
``ops/``, ``cmvm/``, ``trace/``, ``runtime/``, ``analysis/``, ``codegen/``,
``converter/``, ``_cli/``). It imports torch and numpy,
never jax and nothing of ``da4ml_tpu``; the modules it needs are its own
copies. Entry points run on the CUDA device unless the caller passes
``device='cpu'``.

The flagship path: trace → CMVM solve (on the host, natively by default,
or by the device search, whose greedy loop is ``csrc/fused_cse.cu``) → DAIS
program → execution by the hand-written CUDA kernel ``csrc/dais_exec.cu``
(``runtime.cuda_backend``). See ``entry.py``. ``native/`` builds the C++ host
library (solver, interpreter, the search's emission) with g++ at first use.
The firmware path: ``converter.trace_model`` turns an ``nn.Module`` into the
trace, and ``codegen.VerilogModel``/``VHDLModel``/``HLSModel`` write the
project once the verifier (``analysis``) passes the program. The command
line, ``python -m da4ml_tpu_torch`` (``convert``, ``report``, ``verify``,
``lint-opcodes``), drives both paths. ``telemetry`` holds the spans, metrics and trace
export of both, and the device profile (``DA4ML_PROFILE``).

The root exports what ``da4ml_tpu``'s does (``da4ml_tpu/__init__.py``):
the IR types at import, ``solve``, ``trace_model``, ``verify`` and
``telemetry`` on first use, so ``import da4ml_tpu_torch`` stays light (no
torch import, no CUDA initialisation).
"""

from .ir import CombLogic, LookupTable, Op, Pipeline, Precision, QInterval, minimal_kif

__version__ = '0.1.0'

__all__ = [
    'CombLogic',
    'Pipeline',
    'Op',
    'QInterval',
    'Precision',
    'LookupTable',
    'minimal_kif',
    'solve',
    'trace_model',
    'verify',
    'telemetry',
    '__version__',
]


def __getattr__(name):
    # heavy surfaces resolve lazily so `import da4ml_tpu_torch` stays light
    if name == 'solve':
        from .cmvm import solve

        return solve
    if name == 'trace_model':
        from .converter import trace_model

        return trace_model
    if name == 'verify':
        from .analysis import verify

        return verify
    if name == 'telemetry':
        import importlib

        return importlib.import_module(f'{__name__}.telemetry')
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')
