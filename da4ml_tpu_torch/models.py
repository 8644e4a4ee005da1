"""``nn.Module`` models for the PyTorch front end (``converter.trace_model``).

``config5_twin`` is the PyTorch twin of ``bench.py``'s config-5 model
(``_trace_model``): the same layers and the same ``default_rng(5)`` weights,
as a module the torch tracer walks. Its relus are not quantized, so it traces
to a different program than ``bench.py``'s, of the same shape of work.
``flagship_twin`` is the same kind of twin of the flagship MLP
(``entry.flagship_comb``).
"""

from __future__ import annotations

import numpy as np

#: the input quantization the twin is traced with: (signed, integer, fractional) bits
CONFIG5_INPUTS_KIF = (1, 3, 2)


def config5_twin(limited: bool = False):
    """``Conv2d(cin, cmid, 3, padding='same')``, ``ReLU``, ``MaxPool2d(2)``,
    ``Flatten(0)``, ``Linear(flat, dense)``, ``ReLU``, ``Linear(dense, 5)``,
    float64 and bias-free, with ``bench.py``'s weights carried in (``w1``
    from [kh, kw, cin, cout] to [cout, cin, kh, kw], ``w2`` and ``w3``
    transposed). Full size: an 8×8×3 input (``input_shape`` (3, 8, 8),
    channels first), 8 conv channels, dense 32; ``limited`` takes bench.py's
    small widths (4×4×2, 4 channels, dense 8). ``Flatten(0)`` flattens one
    unbatched sample, as the tracer sees it: call the module on a (C, H, W)
    tensor."""
    import torch
    import torch.nn as nn

    rng = np.random.default_rng(5)
    side, cin, cmid, dense = (4, 2, 4, 8) if limited else (8, 3, 8, 32)
    flat = (side // 2) ** 2 * cmid
    w1 = rng.integers(-32, 32, (3, 3, cin, cmid)).astype(np.float64)
    w2 = rng.integers(-32, 32, (flat, dense)).astype(np.float64)
    w3 = rng.integers(-32, 32, (dense, 5)).astype(np.float64)
    model = nn.Sequential(
        nn.Conv2d(cin, cmid, 3, padding='same', bias=False),
        nn.ReLU(),
        nn.MaxPool2d(2),
        nn.Flatten(0),
        nn.Linear(flat, dense, bias=False),
        nn.ReLU(),
        nn.Linear(dense, 5, bias=False),
    ).to(torch.float64)
    with torch.no_grad():
        model[0].weight.copy_(torch.from_numpy(w1.transpose(3, 2, 0, 1).copy()))
        model[4].weight.copy_(torch.from_numpy(w2.T.copy()))
        model[6].weight.copy_(torch.from_numpy(w3.T.copy()))
    model.input_shape = (cin, side, side)
    return model.eval()


def flagship_twin():
    """``Linear(16, 32)``, ``ReLU``, ``Linear(32, 32)``, ``ReLU``,
    ``Linear(32, 5)``, bias-free, with ``entry.flagship_comb``'s
    ``default_rng(20260729)`` 4-bit integer weights; traced with inputs
    (1, 3, 2) (``CONFIG5_INPUTS_KIF``). Its relus are not quantized, so its
    program differs from the flagship's, with the same widths. float32, the
    dtype of the command line's validation forward."""
    import torch
    import torch.nn as nn

    rng = np.random.default_rng(20260729)
    dims = [16, 32, 32, 5]
    layers = []
    for li in range(len(dims) - 1):
        lin = nn.Linear(dims[li], dims[li + 1], bias=False)
        with torch.no_grad():
            lin.weight.copy_(torch.from_numpy(rng.integers(-8, 8, (dims[li], dims[li + 1])).astype(np.float32).T.copy()))
        layers += [lin, nn.ReLU()] if li < len(dims) - 2 else [lin]
    model = nn.Sequential(*layers)
    model.input_shape = (dims[0],)
    return model.eval()
