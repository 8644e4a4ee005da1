"""da4ml_tpu_torch — the PyTorch/CUDA port of ``da4ml_tpu``

A second package beside ``da4ml_tpu`` with the same layout (``ir/``,
``ops/``, ``cmvm/``, ``trace/``, ``runtime/``). It imports torch and numpy,
never jax and nothing of ``da4ml_tpu``; the modules it needs are its own
copies. Entry points run on the CUDA device unless the caller passes
``device='cpu'``.

The first slice carries the flagship path: trace → host CMVM solve → DAIS
program → execution by the hand-written CUDA kernel ``csrc/dais_exec.cu``
(``runtime.cuda_backend``). See ``entry.py``.
"""

__version__ = '0.1.0'
