"""The port's PyTorch front end against the JAX package's, model for model.

The torch models of ``tests/test_frontends.py`` (MLP, residual, conv,
depthwise with padding and upsampling, leaky/PReLU, relu6/hardtanh/clamp,
slicing with maximum, 1-d pooling, ``cat``) are traced by both packages'
``trace_model`` with the native solver (``'cpp'``): the programs are
byte-identical, and the port's ``predict`` (its executor's plain version on
the CPU) equals the module's own forward on integer inputs. The rejections
(padded pooling, partial flattening, explicit conv padding) raise the same
error types in both. A small config-5 twin (``config5_twin(limited=True)``)
goes end to end: ``trace_model`` with the native solver and with the device
search (its plain version on the CPU), each byte-identical to the reference's
trace with the same solver, then ``VerilogModel`` at latency 5 (project equal
to the reference's), K1's plain version and the netlist simulator, equal to
the module's float64 forward. Tolerance is exact."""

import numpy as np
import pytest
import torch

import da4ml_tpu.converter as jconverter
import da4ml_tpu.trace as jtrace
import da4ml_tpu_torch.converter as tconverter
import da4ml_tpu_torch.trace as ttrace


class _TorchMLP(torch.nn.Module):
    input_shape = (8,)

    def __init__(self):
        super().__init__()
        self.fc1 = torch.nn.Linear(8, 6)
        self.act = torch.nn.ReLU()
        self.fc2 = torch.nn.Linear(6, 3)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class _TorchResidual(torch.nn.Module):
    input_shape = (6,)

    def __init__(self):
        super().__init__()
        self.fc = torch.nn.Linear(6, 6)
        self.out = torch.nn.Linear(6, 2)

    def forward(self, x):
        return self.out(torch.relu(self.fc(x)) + x)


class _TorchConv(torch.nn.Module):
    input_shape = (1, 6, 6)

    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv2d(1, 2, 3)
        self.act = torch.nn.ReLU()
        self.flat = torch.nn.Flatten(0)
        self.fc = torch.nn.Linear(32, 3)

    def forward(self, x):
        return self.fc(self.flat(self.act(self.conv(x))))


class _TorchCat(torch.nn.Module):
    input_shape = (4,)

    def __init__(self):
        super().__init__()
        self.fc = torch.nn.Linear(4, 3)

    def forward(self, x):
        return torch.cat([self.fc(x), x], dim=1)


class _TorchDepthwise(torch.nn.Module):
    input_shape = (2, 6, 6)

    def __init__(self):
        super().__init__()
        self.pad = torch.nn.ZeroPad2d((1, 0, 0, 1))
        self.dw = torch.nn.Conv2d(2, 4, 3, groups=2)
        self.act = torch.nn.ReLU()
        self.up = torch.nn.Upsample(scale_factor=2, mode='nearest')
        self.pool = torch.nn.MaxPool2d(2)
        self.flat = torch.nn.Flatten(0)

    def forward(self, x):
        return self.flat(self.pool(self.up(self.act(self.dw(self.pad(x))))))

    def batched(self, x):
        """The forward on a batch (``Upsample`` needs the batch axis)."""
        return torch.nn.Sequential(self.pad, self.dw, self.act, self.up, self.pool)(x).flatten(1)


class _TorchLeaky(torch.nn.Module):
    input_shape = (6,)

    def __init__(self):
        super().__init__()
        self.fc = torch.nn.Linear(6, 6)
        self.lk = torch.nn.LeakyReLU(0.25)
        self.pr = torch.nn.PReLU(6, init=0.5)

    def forward(self, x):
        return self.pr(self.lk(self.fc(x)))


class _TorchFnLeaky(torch.nn.Module):
    input_shape = (6,)

    def __init__(self):
        super().__init__()
        self.fc = torch.nn.Linear(6, 6)

    def forward(self, x):
        import torch.nn.functional as F

        return F.leaky_relu(self.fc(x), 0.25)


class _TorchClamp(torch.nn.Module):
    input_shape = (6,)

    def __init__(self):
        super().__init__()
        self.fc = torch.nn.Linear(6, 6)
        self.r6 = torch.nn.ReLU6()
        self.ht = torch.nn.Hardtanh(-2.0, 3.0)

    def forward(self, x):
        return torch.clamp(self.ht(self.r6(self.fc(x))), min=-1.0, max=2.5)


class _TorchSliceMax(torch.nn.Module):
    input_shape = (8,)

    def __init__(self):
        super().__init__()
        self.fc = torch.nn.Linear(8, 8)

    def forward(self, x):
        y = self.fc(x)
        return torch.maximum(y[:, :4], y[:, 4:])


class _TorchPool1d(torch.nn.Module):
    input_shape = (2, 8)

    def __init__(self):
        super().__init__()
        self.dw = torch.nn.Conv1d(2, 2, 3, groups=2)
        self.mp = torch.nn.MaxPool1d(2)
        self.ap = torch.nn.AvgPool1d(2, stride=1)
        self.flat = torch.nn.Flatten(0)

    def forward(self, x):
        return self.flat(self.ap(self.mp(self.dw(x))))


#: model class -> (weight range, per-sample forward); the weights and inputs
#: are integers, so the module's float32 forward is exact
MODELS = {
    'mlp': (_TorchMLP, (-4, 4), False),
    'residual': (_TorchResidual, (-4, 4), False),
    'conv': (_TorchConv, (-3, 3), True),
    'cat': (_TorchCat, (-4, 4), False),
    'depthwise_pad_upsample': (_TorchDepthwise, (-3, 3), False),
    'leaky_prelu': (_TorchLeaky, (-3, 3), False),
    'functional_leaky_relu': (_TorchFnLeaky, (-3, 3), False),
    'relu6_hardtanh_clamp': (_TorchClamp, (-3, 3), False),
    'getitem_maximum': (_TorchSliceMax, (-3, 3), False),
    'pool1d_depthwise': (_TorchPool1d, (-3, 3), True),
}


def _model(name):
    cls, (lo, hi), _ = MODELS[name]
    model = cls()
    rng = np.random.default_rng(42)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.tensor(rng.integers(lo, hi, tuple(p.shape)).astype(np.float32)))
        if isinstance(model, _TorchLeaky):
            model.pr.weight.fill_(0.5)
    return model


def _forward(name, model, data):
    x = torch.tensor(data.reshape((len(data), *model.input_shape)).astype(np.float32))
    with torch.no_grad():
        if hasattr(model, 'batched'):
            y = model.batched(x)
        elif MODELS[name][2]:
            y = torch.stack([model(row) for row in x])
        else:
            y = model(x)
    return y.numpy().astype(np.float64).reshape(len(data), -1)


def _trace_both(model, backend='cpp', kif=(1, 3, 0)):
    port = ttrace.comb_trace(*tconverter.trace_model(model, ttrace.HWConfig(1, -1, -1), {'backend': backend},
                                                     inputs_kif=kif))  # fmt: skip
    ref = jtrace.comb_trace(*jconverter.trace_model(model, jtrace.HWConfig(1, -1, -1), {'backend': backend},
                                                    inputs_kif=kif))  # fmt: skip
    return port, ref


@pytest.mark.parametrize('name', sorted(MODELS))
def test_torch_model_trace_and_predict(name, monkeypatch):
    monkeypatch.setenv('DA4ML_RUN_MODE', 'level')  # the subject is not the mode: no race
    model = _model(name)
    port, ref = _trace_both(model)
    assert np.array_equal(port.to_binary(), ref.to_binary()) and port.cost == ref.cost
    data = np.random.default_rng(7).integers(-4, 4, (16, int(np.prod(model.input_shape)))).astype(np.float64)
    got = port.predict(data, device='cpu')
    np.testing.assert_array_equal(got, ref.predict(data, backend='numpy'))
    np.testing.assert_array_equal(got, _forward(name, model, data))


def test_dump_returns_every_named_trace():
    model = _model('residual')
    traces = tconverter.trace_model(model, ttrace.HWConfig(1, -1, -1), {'backend': 'cpp'}, inputs_kif=(1, 3, 0),
                                    dump=True)  # fmt: skip
    ref = jconverter.trace_model(model, jtrace.HWConfig(1, -1, -1), {'backend': 'cpp'}, inputs_kif=(1, 3, 0),
                                 dump=True)  # fmt: skip
    assert list(traces) == list(ref) and 'output_0' in traces


class _PaddedPool(torch.nn.Module):
    input_shape = (1, 6, 6)

    def __init__(self):
        super().__init__()
        self.pool = torch.nn.MaxPool2d(2, padding=1)

    def forward(self, x):
        return self.pool(x)


class _PartialFlatten(torch.nn.Module):
    input_shape = (2, 3, 4)

    def forward(self, x):
        return torch.flatten(x, 2)


class _PaddedConv(torch.nn.Module):
    input_shape = (1, 6, 6)

    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv2d(1, 2, 3, padding=1)

    def forward(self, x):
        return self.conv(x)


@pytest.mark.parametrize('cls,match', [(_PaddedPool, 'padding'), (_PartialFlatten, 'flatten'), (_PaddedConv, 'padding')])
def test_rejections_match_the_reference(cls, match):
    model = cls()
    errors = []
    for conv, trace in ((tconverter, ttrace), (jconverter, jtrace)):
        with pytest.raises(NotImplementedError, match=match) as e:
            conv.trace_model(model, trace.HWConfig(1, -1, -1), inputs_kif=(1, 3, 0))
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_plugin_registry_is_the_ports_own():
    plugins = tconverter.get_available_plugins()
    assert tconverter.ENTRY_POINT_GROUP == 'da4ml_tpu_torch.plugins'
    assert plugins['torch'] == 'da4ml_tpu_torch.converter.torch_plugin:TorchTracer'
    assert 'keras' not in plugins and 'da4ml_tpu' not in plugins
    with pytest.raises(ValueError, match='No plugin found'):
        tconverter.trace_model(object(), ttrace.HWConfig(1, -1, -1))


def test_config5_twin_end_to_end(tmp_path, monkeypatch):
    """The small config-5 twin: traced with the native solver and the device
    search (on the CPU), each equal to the reference's trace with the same
    solver ('jax' for the device search); its Verilog project at latency 5
    equal to the reference's; K1's plain version and the netlist simulator
    equal to the module's float64 forward on the input grid."""
    monkeypatch.setenv('DA4ML_RUN_MODE', 'level')  # the subject is not the mode: no race
    import da4ml_tpu.codegen as jcodegen

    from da4ml_tpu_torch.codegen import VerilogModel
    from da4ml_tpu_torch.models import CONFIG5_INPUTS_KIF, config5_twin

    model = config5_twin(limited=True)
    port, ref = _trace_both(model, 'cpp', CONFIG5_INPUTS_KIF)
    assert np.array_equal(port.to_binary(), ref.to_binary())
    dev = ttrace.comb_trace(*tconverter.trace_model(model, ttrace.HWConfig(1, -1, -1),
                                                    {'backend': 'torch', 'device': 'cpu'},
                                                    inputs_kif=CONFIG5_INPUTS_KIF))  # fmt: skip
    ref_dev = jtrace.comb_trace(*jconverter.trace_model(model, jtrace.HWConfig(1, -1, -1), {'backend': 'jax'},
                                                        inputs_kif=CONFIG5_INPUTS_KIF))  # fmt: skip
    assert np.array_equal(dev.to_binary(), ref_dev.to_binary())

    rtl = VerilogModel(dev, 'twin', tmp_path / 'port', latency_cutoff=5).write()
    jcodegen.VerilogModel(ref_dev, 'twin', tmp_path / 'ref', latency_cutoff=5).write()
    files = [p.relative_to(tmp_path / 'port') for p in sorted((tmp_path / 'port').rglob('*')) if p.is_file()]
    assert files and all((tmp_path / 'port' / f).read_bytes() == (tmp_path / 'ref' / f).read_bytes() for f in files)
    assert len(files) == sum(1 for p in (tmp_path / 'ref').rglob('*') if p.is_file())

    data = np.floor(np.random.default_rng(5).uniform(-8, 8, (12, dev.shape[0])) * 4) / 4
    want = np.stack([model(torch.from_numpy(row.reshape(model.input_shape))).detach().numpy() for row in data])
    np.testing.assert_array_equal(rtl.predict(data, backend='interp', device='cpu'), want)
    np.testing.assert_array_equal(dev.predict(data, device='cpu'), want)
    np.testing.assert_array_equal(rtl.predict(data, backend='netlist'), want)

