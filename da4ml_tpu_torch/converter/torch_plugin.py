"""PyTorch front-end: trace ``nn.Module`` graphs into the DAIS graph.

Models are walked with ``torch.fx`` symbolic tracing, so arbitrary
``forward`` topologies (residual adds, concats, reshapes) trace without the
module being a plain ``nn.Sequential``. Every node is replayed with
numpy-protocol ops over ``FixedVariableArray``s; Linear and Conv layers route
through the CMVM optimizer. Tracing is per-sample — the batch dimension is
dropped, and channels-first conv tensors are handled by transposing to
channels-last around the im2col convolution. Unquantized nonlinearities
(softmax, sigmoid, ...) are rejected.

Counterpart of ``da4ml_tpu/converter/torch_plugin.py``.
"""

from __future__ import annotations

import logging
import operator
from typing import Any

import numpy as np

from ..trace import FixedVariableArray
from ..trace.ops import (
    avg_pool1d,
    avg_pool2d,
    conv1d,
    conv2d,
    depthwise_conv1d,
    depthwise_conv2d,
    leaky_relu,
    max_pool1d,
    max_pool2d,
    relu,
    relu6,
    upsample_nearest,
    zero_pad,
)
from .plugin import TracerPluginBase

_logger = logging.getLogger(__name__)


def _one(v) -> int:
    """A scalar kernel/stride parameter (torch 1-d modules store int or 1-tuple)."""
    return int(v[0] if isinstance(v, (tuple, list)) else v)


def _w(t) -> np.ndarray:
    return np.asarray(t.detach().cpu().numpy(), dtype=np.float64)


def _chw_to_hwc(x):
    return x.transpose((1, 2, 0)) if x.ndim == 3 else x.transpose((1, 0))


def _hwc_to_chw(x):
    return x.transpose((2, 0, 1)) if x.ndim == 3 else x.transpose((1, 0))


class TorchTracer(TracerPluginBase):
    """Tracer plugin for ``torch.nn.Module`` via ``torch.fx``."""

    def get_input_shapes(self):
        shape = getattr(self.model, 'input_shape', None)
        if shape is None:
            return None
        shape = tuple(int(d) for d in shape)
        return [shape]

    # ------------------------------------------------------------ modules

    def _trace_module(self, mod, args: tuple):
        import torch.nn as nn

        x = args[0]
        if isinstance(mod, nn.Linear):
            y = x @ _w(mod.weight).T
            if mod.bias is not None:
                y = y + _w(mod.bias)
            return y
        if isinstance(mod, nn.ReLU):
            return relu(x)
        if isinstance(mod, nn.ReLU6):
            return relu6(x)
        if isinstance(mod, nn.Hardtanh):
            return np.minimum(np.maximum(x, float(mod.min_val)), float(mod.max_val))
        if isinstance(mod, nn.LeakyReLU):
            return leaky_relu(x, float(mod.negative_slope))
        if isinstance(mod, nn.PReLU):
            alpha = _w(mod.weight)
            if alpha.size > 1:  # per-channel: broadcast over trailing spatial dims
                alpha = alpha.reshape((alpha.size,) + (1,) * (x.ndim - 1))
            return leaky_relu(x, alpha)
        if isinstance(mod, nn.Flatten):
            if mod.start_dim not in (0, 1) or mod.end_dim != -1:
                raise NotImplementedError('Only full flattening (start_dim 0/1, end_dim -1) is supported')
            return x.reshape(-1)
        if isinstance(mod, (nn.Dropout, nn.Identity)):
            return x
        if isinstance(mod, nn.Conv2d):
            depthwise = mod.groups == mod.in_channels and mod.out_channels % mod.in_channels == 0
            if mod.groups != 1 and not depthwise:
                raise NotImplementedError('Grouped convolutions are only supported when depthwise (groups == in_channels)')
            pad = mod.padding
            if pad == 'same' or pad == (0, 0) or pad == 'valid':
                padding = 'same' if pad == 'same' else 'valid'
            else:
                raise NotImplementedError(f'Explicit padding {pad} is not supported (use 0 or "same")')
            if depthwise and mod.groups != 1:
                cin, mult = mod.in_channels, mod.out_channels // mod.in_channels
                # [cin*mult, 1, kh, kw] -> [kh, kw, cin, mult]; torch groups
                # output channels by input group, matching c*mult + m order
                k = _w(mod.weight).reshape(cin, mult, *mod.kernel_size).transpose(2, 3, 0, 1)
                y = depthwise_conv2d(_chw_to_hwc(x), k, strides=mod.stride, padding=padding, dilation=mod.dilation)
            else:
                k = _w(mod.weight).transpose(2, 3, 1, 0)  # [cout,cin,kh,kw] -> [kh,kw,cin,cout]
                y = conv2d(_chw_to_hwc(x), k, strides=mod.stride, padding=padding, dilation=mod.dilation)
            if mod.bias is not None:
                y = y + _w(mod.bias)
            return _hwc_to_chw(y)
        if isinstance(mod, nn.Conv1d):
            depthwise = mod.groups == mod.in_channels and mod.out_channels % mod.in_channels == 0
            if mod.groups != 1 and not depthwise:
                raise NotImplementedError('Grouped convolutions are only supported when depthwise (groups == in_channels)')
            pad = mod.padding
            if pad not in ('same', 'valid', (0,), 0):
                raise NotImplementedError(f'Explicit padding {pad} is not supported (use 0 or "same")')
            if depthwise and mod.groups != 1:
                cin, mult = mod.in_channels, mod.out_channels // mod.in_channels
                k = _w(mod.weight).reshape(cin, mult, mod.kernel_size[0]).transpose(2, 0, 1)  # [k, cin, mult]
                y = depthwise_conv1d(_chw_to_hwc(x), k, stride=mod.stride[0],
                                     padding='same' if pad == 'same' else 'valid', dilation=mod.dilation[0])  # fmt: skip
            else:
                k = _w(mod.weight).transpose(2, 1, 0)  # [cout,cin,k] -> [k,cin,cout]
                y = conv1d(_chw_to_hwc(x), k, stride=mod.stride[0], padding='same' if pad == 'same' else 'valid',
                           dilation=mod.dilation[0])  # fmt: skip
            if mod.bias is not None:
                y = y + _w(mod.bias)
            return _hwc_to_chw(y)
        if isinstance(mod, (nn.MaxPool1d, nn.AvgPool1d)):
            if np.any(np.asarray(mod.padding)) or getattr(mod, 'ceil_mode', False):
                raise NotImplementedError('Pooling padding/ceil_mode are not supported')
            if np.any(np.asarray(getattr(mod, 'dilation', 1)) != 1):
                raise NotImplementedError('Dilated pooling is not supported')
            pool = max_pool1d if isinstance(mod, nn.MaxPool1d) else avg_pool1d
            y = pool(_chw_to_hwc(x), _one(mod.kernel_size), _one(mod.stride), 'valid')
            return _hwc_to_chw(y)
        if isinstance(mod, nn.ZeroPad2d):
            left, right, top, bottom = (int(v) for v in mod.padding)
            y = zero_pad(_chw_to_hwc(x), [(top, bottom), (left, right)])
            return _hwc_to_chw(y)
        if isinstance(mod, nn.Upsample):
            if mod.mode != 'nearest' or mod.size is not None:
                raise NotImplementedError('Only nearest-neighbor scale_factor upsampling is traceable')
            sf = mod.scale_factor
            raw = tuple(sf) if isinstance(sf, (tuple, list)) else (sf,) * (x.ndim - 1)
            if any(float(s) != int(s) for s in raw):
                raise NotImplementedError(f'Non-integral upsampling scale_factor {sf} is not traceable')
            sizes = tuple(int(s) for s in raw)
            y = upsample_nearest(_chw_to_hwc(x), sizes)
            return _hwc_to_chw(y)
        if isinstance(mod, (nn.MaxPool2d, nn.AvgPool2d)):
            if np.any(np.asarray(mod.padding)) or getattr(mod, 'ceil_mode', False):
                raise NotImplementedError('Pooling padding/ceil_mode are not supported')
            if np.any(np.asarray(getattr(mod, 'dilation', 1)) != 1):
                raise NotImplementedError('Dilated pooling is not supported')
            if isinstance(mod, nn.AvgPool2d) and not mod.count_include_pad:
                raise NotImplementedError('count_include_pad=False is not supported')
            pool = max_pool2d if isinstance(mod, nn.MaxPool2d) else avg_pool2d
            y = pool(_chw_to_hwc(x), mod.kernel_size, mod.stride, 'valid')
            return _hwc_to_chw(y)
        if isinstance(mod, nn.BatchNorm1d) or isinstance(mod, nn.BatchNorm2d):
            eps = float(mod.eps)
            gamma = _w(mod.weight) if mod.weight is not None else 1.0
            beta = _w(mod.bias) if mod.bias is not None else 0.0
            mean = _w(mod.running_mean)
            var = _w(mod.running_var)
            a = gamma / np.sqrt(var + eps)
            b = beta - mean * a
            if isinstance(mod, nn.BatchNorm2d):  # channels-first [C, H, W]
                a, b = a[:, None, None], b[:, None, None]
            elif x.ndim == 2:  # channels-first [C, L]
                a, b = a[:, None], b[:, None]
            return x * a + b
        raise NotImplementedError(f'Module type {type(mod).__name__} is not supported by the torch tracer')

    # ------------------------------------------------------------ functions

    @staticmethod
    def _sample_axis(dim: int, ndim: int) -> int:
        """Map a batched-tensor dim (the convention of a torch ``forward``) to
        the per-sample axis: tracing drops the batch dim, so dim 0 is illegal
        and positive dims shift down by one; negative dims are unchanged."""
        if dim >= 0:
            if dim == 0:
                raise NotImplementedError('Operations along the batch dimension (dim=0) are not traceable')
            return dim - 1
        if dim < -ndim:
            raise IndexError(f'dim {dim} out of range for per-sample rank {ndim}')
        return dim

    def _trace_function(self, fn, args, kwargs):
        import torch
        import torch.nn.functional as F

        if fn in (operator.add, torch.add):
            return args[0] + args[1]
        if fn in (operator.sub, torch.sub):
            return args[0] - args[1]
        if fn in (operator.mul, torch.mul):
            return args[0] * args[1]
        if fn in (torch.relu, F.relu):
            return relu(args[0])
        if fn is F.leaky_relu:
            slope = float(kwargs.get('negative_slope', args[1] if len(args) > 1 else 0.01))
            return leaky_relu(args[0], slope)
        if fn in (torch.clamp, torch.clip):
            lo = kwargs.get('min', args[1] if len(args) > 1 else None)
            hi = kwargs.get('max', args[2] if len(args) > 2 else None)
            y = args[0]
            # scalar or tensor bounds (per-channel clamp broadcasts like Hardtanh)
            if lo is not None:
                y = np.maximum(y, np.asarray(lo, dtype=np.float64))
            if hi is not None:
                y = np.minimum(y, np.asarray(hi, dtype=np.float64))
            return y
        if fn in (torch.cat,):
            dim = kwargs.get('dim', args[1] if len(args) > 1 else 0)
            vals = args[0]
            return np.concatenate(vals, axis=self._sample_axis(int(dim), vals[0].ndim))
        if fn in (torch.flatten,):
            start = int(kwargs.get('start_dim', args[1] if len(args) > 1 else 0))
            end = int(kwargs.get('end_dim', args[2] if len(args) > 2 else -1))
            if start not in (0, 1) or end != -1:
                raise NotImplementedError('Only full flattening (start_dim 0/1, end_dim -1) is supported')
            return args[0].reshape(-1)
        if fn in (torch.matmul,):
            return args[0] @ args[1]
        if fn is operator.getitem:
            # slicing/cropping: model tensors are batched [N, ...], traced
            # arrays are per-sample — only a [:, ...] tuple (full slice on
            # the batch axis, then feature-axis slices) maps cleanly. A bare
            # x[0] / x[2:5] would index the batch axis: not traceable.
            idx = args[1]
            if not (isinstance(idx, tuple) and idx and idx[0] == slice(None)):
                raise NotImplementedError('Indexing that touches the batch axis is not traceable')
            return args[0][idx[1:]]
        if fn in (torch.maximum, torch.max, torch.minimum, torch.min) and len(args) == 2:
            # elementwise two-tensor form only; torch.max(y, dim) is a
            # reduction returning (values, indices) — reject int dims rather
            # than silently clamping elementwise
            if not hasattr(args[1], 'ndim'):
                raise NotImplementedError('torch.max/min with a dim argument is not supported; use elementwise maximum/minimum')
            return (np.maximum if fn in (torch.maximum, torch.max) else np.minimum)(args[0], args[1])
        raise NotImplementedError(f'Function {getattr(fn, "__name__", fn)!r} is not supported by the torch tracer')

    # ------------------------------------------------------------ model walk

    def apply_model(self, verbose: bool, inputs: tuple[FixedVariableArray, ...]):
        import torch.fx as fx

        model = self.model.eval() if hasattr(self.model, 'eval') else self.model
        graph_module = fx.symbolic_trace(model)
        env: dict[str, Any] = {}
        traces: dict[str, Any] = {}
        it = iter(inputs)

        def lookup(a):
            if isinstance(a, fx.Node):
                return env[a.name]
            if isinstance(a, (list, tuple)):
                return type(a)(lookup(x) for x in a)
            return a

        out_names: list[str] = []
        for node in graph_module.graph.nodes:
            if node.op == 'placeholder':
                env[node.name] = next(it)
            elif node.op == 'get_attr':
                target = graph_module
                for part in node.target.split('.'):
                    target = getattr(target, part)
                env[node.name] = _w(target)
            elif node.op == 'call_module':
                mod = graph_module.get_submodule(node.target)
                env[node.name] = self._trace_module(mod, tuple(lookup(a) for a in node.args))
            elif node.op == 'call_function':
                env[node.name] = self._trace_function(
                    node.target, tuple(lookup(a) for a in node.args), {k: lookup(v) for k, v in node.kwargs.items()}
                )
            elif node.op == 'call_method':
                obj = lookup(node.args[0])
                m_args = tuple(lookup(a) for a in node.args[1:])
                if node.target in ('reshape', 'view'):
                    env[node.name] = obj.reshape(*m_args)
                elif node.target == 'flatten':
                    start = int(m_args[0]) if m_args else 0
                    end = int(m_args[1]) if len(m_args) > 1 else -1
                    if start not in (0, 1) or end != -1:
                        raise NotImplementedError('Only full flattening (start_dim 0/1, end_dim -1) is supported')
                    env[node.name] = obj.reshape(-1)
                elif node.target == 'permute':
                    dims = m_args[0] if len(m_args) == 1 and isinstance(m_args[0], (list, tuple)) else m_args
                    dims = [int(d) for d in dims]
                    if dims and dims[0] == 0:  # batched permute keeping batch first
                        axes = [d - 1 for d in dims[1:]]
                    else:
                        raise NotImplementedError('permute must keep the batch dimension first (dims[0] == 0)')
                    env[node.name] = obj.transpose(axes)
                elif node.target == 'transpose':
                    a = self._sample_axis(int(m_args[0]), obj.ndim)
                    b = self._sample_axis(int(m_args[1]), obj.ndim)
                    axes = list(range(obj.ndim))
                    axes[a], axes[b] = axes[b], axes[a]
                    env[node.name] = obj.transpose(axes)
                else:
                    raise NotImplementedError(f'Method {node.target!r} is not supported by the torch tracer')
            elif node.op == 'output':
                outs = lookup(node.args[0])
                outs = outs if isinstance(outs, (list, tuple)) else (outs,)
                for i, o in enumerate(outs):
                    name = f'output_{i}'
                    traces[name] = o
                    out_names.append(name)
            else:
                raise NotImplementedError(f'fx op {node.op!r} unsupported')
            if verbose and node.op not in ('output',):
                v = env.get(node.name)
                _logger.info(f'  {node.name}: {getattr(v, "shape", None)}')
            if node.op != 'output':
                traces[node.name] = env[node.name]
        return traces, out_names
