"""Converter front-end: plugin discovery and ``trace_model``.

Plugins are resolved by the root module name of the model's class (a
``torch.nn.Module`` resolves to the plugin registered under ``torch``), from
two sources merged in priority order:

1. in-process registrations via :func:`register_plugin`;
2. installed-package entry points in the group ``da4ml_tpu_torch.plugins``.

The port's registry maps ``torch`` to its own :class:`TorchTracer`, and
pre-registers its example plugin (``converter/example.py``) under
``da4ml_tpu_torch``, so the stack is exercisable without any third-party
framework. It reads only its own entry-point group, so an installed
reference package never supplies a tracer here. The reference's Keras
plugin is not ported.

Counterpart of ``da4ml_tpu/converter/__init__.py``.
"""

from __future__ import annotations

from importlib import import_module
from importlib.metadata import entry_points
from typing import Any

from .. import telemetry
from ..cmvm import solver_options_t
from ..trace import FixedVariableArray, HWConfig
from .plugin import TracerPluginBase, flatten_arrays

__all__ = [
    'ENTRY_POINT_GROUP',
    'TracerPluginBase',
    'flatten_arrays',
    'get_available_plugins',
    'register_plugin',
    'trace_model',
]

ENTRY_POINT_GROUP = 'da4ml_tpu_torch.plugins'


# name -> plugin class or 'module:attr' lazy spec
_REGISTRY: dict[str, Any] = {
    'da4ml_tpu_torch': 'da4ml_tpu_torch.converter.example:ExampleTracer',
    'torch': 'da4ml_tpu_torch.converter.torch_plugin:TorchTracer',
}


def register_plugin(framework: str, plugin: type[TracerPluginBase] | str) -> None:
    """Register a tracer plugin for a framework root-module name in-process."""
    _REGISTRY[framework] = plugin


def _resolve(spec: Any) -> type[TracerPluginBase]:
    if isinstance(spec, str):
        module, _, attr = spec.partition(':')
        return getattr(import_module(module), attr)
    return spec


def get_available_plugins() -> dict[str, Any]:
    """All known plugins: entry points overlaid by in-process registrations."""
    plugins: dict[str, Any] = {}
    try:
        for ep in entry_points().select(group=ENTRY_POINT_GROUP):
            plugins[ep.name] = ep
    except Exception:
        pass
    plugins.update(_REGISTRY)
    return plugins


def trace_model(
    model: Any,
    hwconf: HWConfig | tuple[int, int, int] = HWConfig(1, -1, -1),
    solver_options: solver_options_t | None = None,
    verbose: bool = False,
    inputs: tuple[FixedVariableArray, ...] | FixedVariableArray | None = None,
    inputs_kif: tuple[int, int, int] | None = None,
    dump: bool = False,
    framework: str | None = None,
    **kwargs: Any,
):
    """Trace ``model`` into symbolic (inputs, outputs) via its framework plugin.

    ``framework`` defaults to the root module of the model's class, found by
    walking the class MRO — a user-defined ``torch.nn.Module`` subclass lives
    in the user's module, but ``torch`` appears among its bases.
    """
    hwconf = HWConfig(*hwconf)
    plugins = get_available_plugins()
    if framework is None:
        for cls_ in type(model).__mro__:
            root = cls_.__module__.split('.', 1)[0]
            if root in plugins:
                framework = root
                break
        else:
            framework = type(model).__module__.split('.', 1)[0]
    if framework not in plugins:
        raise ValueError(f'No plugin found for framework {framework!r}. Available: {sorted(plugins)}')

    spec = plugins[framework]
    if hasattr(spec, 'load'):  # importlib.metadata.EntryPoint
        cls = spec.load()
    else:
        cls = _resolve(spec)

    if verbose:
        telemetry.get_logger('converter').info(
            f'Tracing with plugin {cls.__module__}.{cls.__qualname__} (framework={framework})'
        )

    tracer = cls(model, hwconf, solver_options, **kwargs)
    with telemetry.span('trace.model', framework=framework):
        return tracer.trace(verbose=verbose, inputs=inputs, inputs_kif=inputs_kif, dump=dump)
