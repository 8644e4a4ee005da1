"""Built-in example model + plugin — the template third parties follow.

A tiny gated-residual block exercising quantize / relu / slicing / a tanh
lookup table / an elementwise variable product / matmul / einsum. The same
``operation`` runs both eagerly on numpy arrays (the golden path) and
symbolically on FixedVariableArrays.

Counterpart of ``da4ml_tpu/converter/example.py``, computation for
computation: the same model traces to the same program in both packages.
"""

from __future__ import annotations

import numpy as np

from ..trace import FixedVariableArray
from ..trace.ops import einsum, quantize, relu
from .plugin import TracerPluginBase


def operation(inp):
    """Example computation, traceable and numpy-executable alike.

    A gated-residual block on a (4, 5) input: the first two rows drive a
    tanh gate, the last two rows go through a CMVM mixing matrix; the gated
    product and the mixed features are concatenated and contracted with a
    per-row head tensor.
    """
    # Deterministic pseudo-random fixed-point weights (exact on a 2^-6 grid).
    w_mix = ((np.arange(35) * 13 + 5) % 29 - 14).reshape(5, 7).astype(np.float64) / 2**6
    w_head = ((np.arange(96) * 7 % 41) - 20).reshape(2, 12, 4).astype(np.float64) / 2**5

    x = quantize(inp, 1, 5, 2)  # inputs must be quantized before use
    head, tail = x[:2], x[2:]

    gate = quantize(np.tanh(head), 1, 0, 6, 'SAT_SYM', 'RND')
    mixed = quantize(tail @ w_mix, 1, 9, 3)  # CMVM-optimized matmul
    gated = quantize(gate * tail, 1, 6, 4)  # elementwise variable product
    resid = relu(np.abs(mixed) - 1)

    feats = np.concatenate([gated, resid], axis=1)  # (2, 12)
    return einsum('ki,kio->ko', feats, w_head)  # CMVM-optimized contraction


class ExampleModel:
    """Tiny callable model for showcasing the plugin system."""

    def __init__(self, input_shape: tuple[int, ...] | None = None):
        self.input_shape = input_shape

    def __call__(self, x):
        return operation(x)


class ExampleTracer(TracerPluginBase):
    """Plugin for :class:`ExampleModel`.

    Registered in-process under the framework name ``da4ml_tpu_torch`` (the
    root module of ``ExampleModel``).
    """

    model: ExampleModel

    def get_input_shapes(self):
        return [self.model.input_shape] if self.model.input_shape is not None else None

    def apply_model(
        self,
        verbose: bool,
        inputs: tuple[FixedVariableArray, ...],
    ) -> tuple[dict[str, FixedVariableArray], list[str]]:
        assert len(inputs) == 1, 'ExampleModel expects a single input.'
        out = operation(inputs[0])
        return {'output': out}, ['output']
