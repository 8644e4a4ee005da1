"""Tracer plugin base class — the front-end extension point.

A framework's plugin is a small subclass that replays its model with
numpy-protocol ops over ``FixedVariableArray`` inputs; everything below
(CMVM optimization, IR, codegen) is framework-agnostic. Subclasses provide
``apply_model`` and ``get_input_shapes``; ``trace`` builds inputs, applies the
model, and flattens the named outputs into a single 1-d array.

Counterpart of ``da4ml_tpu/converter/plugin.py``.
"""

from __future__ import annotations

from collections.abc import Callable, Sequence
from typing import Any

import numpy as np

from ..cmvm import solver_options_t
from ..trace import FixedVariable, FixedVariableArray, FixedVariableArrayInput, HWConfig


def flatten_arrays(args: Any) -> FixedVariableArray | None:
    """Ravel-and-concatenate any nesting of FixedVariableArray/FixedVariable."""
    if isinstance(args, FixedVariableArray):
        return np.ravel(args)  # type: ignore[return-value]
    if isinstance(args, FixedVariable):
        return FixedVariableArray(np.array([args]))
    if isinstance(args, Sequence) and not isinstance(args, (str, bytes)):
        flat = [flatten_arrays(a) for a in args]
        flat = [a for a in flat if a is not None]
        if not flat:
            return None
        return np.concatenate(flat)  # type: ignore[return-value]
    return None


class TracerPluginBase:
    """Base class for DAIS tracer plugins.

    Subclasses implement:

    - ``apply_model(verbose, inputs) -> (dict[name, FixedVariableArray], [output names])``
    - ``get_input_shapes() -> list[shape] | None``
    """

    def __init__(
        self,
        model: Callable,
        hwconf: HWConfig,
        solver_options: solver_options_t | None = None,
        **kwargs: Any,
    ):
        self.model = model
        self.hwconf = hwconf
        self.solver_options = solver_options
        if kwargs:
            raise TypeError(f'Unexpected keyword arguments: {sorted(kwargs)}')

    # -------------------------------------------------------- to implement

    def apply_model(
        self,
        verbose: bool,
        inputs: tuple[FixedVariableArray, ...],
    ) -> tuple[dict[str, Any], list[str]]:
        """Replay the model over symbolic inputs.

        Returns a dict of every named intermediate trace and the list of
        output names (keys into the dict, in output order).
        """
        raise NotImplementedError

    def get_input_shapes(self) -> Sequence[tuple[int, ...]] | None:
        """Input shapes (batch dim excluded), or None if not inferable."""
        raise NotImplementedError

    # ------------------------------------------------------------ plumbing

    def _get_inputs(
        self,
        inputs: tuple[FixedVariableArray, ...] | FixedVariableArray | None,
        inputs_kif: tuple[int, int, int] | Sequence[tuple[int, int, int]] | None,
    ) -> tuple[FixedVariableArray, ...]:
        if inputs is not None:
            return inputs if isinstance(inputs, tuple) else (inputs,)

        shapes = self.get_input_shapes()
        if shapes is None:
            raise ValueError('Inputs must be provided: cannot determine input shapes automatically.')

        if inputs_kif is None:
            # Unquantized sentinel inputs: the first quantize() call on each
            # records the input precision.
            return tuple(FixedVariableArrayInput(shape, self.hwconf, self.solver_options) for shape in shapes)

        kifs: Sequence[tuple[int, int, int]]
        if not isinstance(inputs_kif[0], Sequence):
            kifs = (inputs_kif,) * len(shapes)  # type: ignore[assignment]
        else:
            kifs = inputs_kif  # type: ignore[assignment]
        if len(kifs) != len(shapes):
            raise ValueError('Length of inputs_kif must match number of inputs')

        return tuple(
            FixedVariableArray.from_kif(
                np.full(shape, kif[0], np.int8),
                np.full(shape, kif[1], np.int8),
                np.full(shape, kif[2], np.int8),
                self.hwconf,
                0.0,
                self.solver_options,
            )
            for kif, shape in zip(kifs, shapes)
        )

    def trace(
        self,
        verbose: bool = False,
        inputs: tuple[FixedVariableArray, ...] | FixedVariableArray | None = None,
        inputs_kif: tuple[int, int, int] | None = None,
        dump: bool = False,
    ):
        """Trace the model.

        With ``dump=True`` returns the dict of all intermediate traces;
        otherwise returns ``(inputs, outputs)`` as flat FixedVariableArrays,
        ready for ``comb_trace``.
        """
        # The reference compiles its device search's shape classes ahead of
        # the solves here (for its 'jax' backend only). The port's search has
        # nothing to prewarm: its rung kernel is built once, for every shape.
        inps = self._get_inputs(inputs, inputs_kif)
        all_traces, output_names = self.apply_model(verbose=verbose, inputs=inps)
        if dump:
            return all_traces
        out = flatten_arrays([all_traces[name] for name in output_names])
        inp = flatten_arrays(inps)
        return inp, out
