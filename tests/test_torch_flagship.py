"""The port's slice end to end at a small size: its trace, host solve and
execution of the flagship-style MLP (8→16→8→3) equal the JAX package's
trace executed by ``DaisExecutor(mode='pallas')`` (interpret mode on the
CPU), and its device search (``backend='torch'``) yields the same program
as the host solve and as the JAX package's ``backend='jax'`` search.
Tolerance is exact."""

import numpy as np
import pytest
import torch

from da4ml_tpu.ir.dais_binary import decode as jdecode
from da4ml_tpu.runtime.jax_backend import DaisExecutor as JaxExecutor
from da4ml_tpu.trace import FixedVariableArrayInput, HWConfig, comb_trace
from da4ml_tpu_torch import entry as entry_mod
from da4ml_tpu_torch.entry import flagship_comb
from da4ml_tpu_torch.ir.dais_binary import decode
from da4ml_tpu_torch.runtime import reference
from da4ml_tpu_torch.runtime.torch_backend import DaisExecutor

SMALL = dict(n_in=8, hidden=(16, 8), n_out=3)


def _jax_flagship(n_in, hidden, n_out, backend='cpu'):
    """``__graft_entry__._flagship_comb`` with the given solver backend."""
    rng = np.random.default_rng(20260729)
    inp = FixedVariableArrayInput(n_in, hwconf=HWConfig(1, -1, -1), solver_options={'backend': backend})
    x = inp.quantize(np.ones(n_in), np.full(n_in, 3), np.full(n_in, 2))
    dims = [n_in, *hidden, n_out]
    for li in range(len(dims) - 1):
        w = rng.integers(-8, 8, (dims[li], dims[li + 1])).astype(np.float64)
        x = x @ w
        if li < len(dims) - 2:
            x = x.relu(i=np.full(dims[li + 1], 5), f=np.full(dims[li + 1], 2))
    return comb_trace(inp, x)


@pytest.fixture(scope='module')
def small():
    return flagship_comb(**SMALL), _jax_flagship(**SMALL)


def test_flagship_slice_matches_jax_pallas(small):
    port, jax_pkg = small
    assert np.array_equal(port.to_binary(), jax_pkg.to_binary())
    data = np.random.default_rng(0).uniform(-8, 8, (200, SMALL['n_in']))
    want = JaxExecutor(jdecode(jax_pkg.to_binary()), mode='pallas')(data)
    ex = DaisExecutor(decode(port.to_binary()), device='cpu')
    assert ex.dtype == torch.int32  # narrow program: the int32 path, as on the card
    np.testing.assert_array_equal(ex(data), want)
    np.testing.assert_array_equal(reference.run_program(ex.prog, data), want)


def test_entry_returns_step_on_requested_device(small, monkeypatch):
    monkeypatch.setattr(entry_mod, 'flagship_comb', lambda: small[0])
    fn, (x,) = entry_mod.entry(device='cpu')
    assert x.device.type == 'cpu' and x.shape == (64, SMALL['n_in'])
    y = fn(x)
    assert y.shape == (64, SMALL['n_out']) and y.dtype == x.dtype
    ex = DaisExecutor(decode(small[0].to_binary()), device='cpu')
    assert torch.equal(y, ex.plain(x))


def test_flagship_is_traced_once_per_shape(small):
    assert flagship_comb(**SMALL) is small[0]


def test_flagship_device_search_matches_host_and_jax(small):
    port_host, _ = small
    port_dev = flagship_comb(**SMALL, backend='torch', device='cpu')
    assert port_dev is not port_host
    want = _jax_flagship(**SMALL, backend='jax').to_binary()
    assert np.array_equal(port_dev.to_binary(), port_host.to_binary())
    assert np.array_equal(port_dev.to_binary(), want)
    assert flagship_comb(**SMALL, backend='torch', device='cpu') is port_dev
