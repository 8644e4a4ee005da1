"""The port's IR fusion (``ir/fuse.py``) and the pipeline methods of
``ir/comb.py`` against the JAX package's.

The same pipelines go to both packages: ``bench.py``'s two fusion workloads at
their small sizes (traced by each package with its native solver, whose
stages are byte-identical), random synth stage chains of every op family, a
single stage and the empty pipeline. ``fuse_binaries``, ``fuse_programs`` and
``fuse_pipeline`` give byte-identical programs and equal ``FusionReport``s,
and the fused program equals the staged reference interpreter. Tolerance is
exact."""

import numpy as np
import pytest
from test_torch_pipeline import PACKAGES, fusion_workloads

import da4ml_tpu.ir.fuse as jfuse
import da4ml_tpu_torch.ir.fuse as tfuse
from da4ml_tpu.ir.comb import Pipeline as JPipeline
from da4ml_tpu.ir.dais_binary import encode
from da4ml_tpu.ir.synth import FAMILIES, random_inputs, random_pipeline
from da4ml_tpu_torch.ir import Pipeline
from da4ml_tpu_torch.ir.dais_binary import decode
from da4ml_tpu_torch.runtime.reference import run_program
from da4ml_tpu_torch.runtime.torch_backend import DaisExecutor


@pytest.fixture(scope='module')
def workloads():
    """``{name: (port Pipeline, reference Pipeline)}`` of the small fusion
    workloads, each package tracing its own with ``'cpp'``."""
    port, ref = (fusion_workloads(pkg, limited=True, backend='cpp') for pkg in PACKAGES)
    return {name: (PACKAGES[0][0].to_pipeline(*port[name], retiming=False),
                   PACKAGES[1][0].to_pipeline(*ref[name], retiming=False)) for name in port}  # fmt: skip


def synth_chains():
    """Random well-formed stage chains (the reference's generator), every op
    family among them: ``[(label, [DaisProgram])]``."""
    chains = []
    for seed in range(3):
        rng = np.random.default_rng(seed)
        chains.append((f'seed {seed}', random_pipeline(rng, n_stages=int(rng.integers(2, 5)), n_ops=60)))
    chains.append(('all families', random_pipeline(np.random.default_rng(7), n_stages=3, n_ops=120, families=FAMILIES)))
    return chains


def staged(progs, data):
    out = data
    for p in progs:
        out = run_program(p, out)
    return out


@pytest.mark.parametrize('name', ['conv_stack', 'transformer_block'])
def test_workload_fuse_matches_jax(workloads, name):
    port, ref = workloads[name]
    fused, rep = port.fuse(report=True)
    ref_fused, ref_rep = ref.fuse(report=True)
    assert tuple(rep) == tuple(ref_rep)
    assert np.array_equal(fused.to_binary(), ref_fused.to_binary())
    binaries = [s.to_binary() for s in port.stages]
    assert np.array_equal(tfuse.fuse_binaries(binaries), jfuse.fuse_binaries(binaries))
    assert np.array_equal(tfuse.fuse_binaries(binaries), fused.to_binary())
    # the fused program on the kernel's plain version equals the staged reference
    data = np.random.default_rng(1).integers(-4, 4, (64, port.shape[0])).astype(np.float64)
    want = staged([decode(b) for b in binaries], data)
    assert np.array_equal(DaisExecutor(decode(fused.to_binary()), device='cpu')(data), want)
    assert np.array_equal(port.predict(data, backend='numpy'), want)


@pytest.mark.parametrize('label, chain', [pytest.param(*c, id=c[0]) for c in synth_chains()])
def test_synth_fuse_matches_jax(label, chain):
    binaries = [encode(p) for p in chain]
    fused = tfuse.fuse_binaries(binaries)
    assert np.array_equal(fused, jfuse.fuse_binaries(binaries)), label
    prog, rep = tfuse.fuse_programs([decode(b) for b in binaries], report=True)
    ref_prog, ref_rep = jfuse.fuse_programs(list(chain), report=True)
    assert tuple(rep) == tuple(ref_rep)
    for field in ('opcode', 'id0', 'id1', 'data_lo', 'data_hi', 'signed', 'integers', 'fractionals', 'out_idxs'):
        assert np.array_equal(getattr(prog, field), getattr(ref_prog, field)), field
    assert set(prog.opcode.tolist()) <= tfuse.FUSABLE_OPCODES
    data = random_inputs(np.random.default_rng(3), chain[0], 48)
    assert np.array_equal(run_program(decode(fused), data), staged([decode(b) for b in binaries], data))


def test_single_stage_is_identity_and_empty_is_refused(workloads):
    stage = workloads['conv_stack'][0].stages[0]
    assert np.array_equal(tfuse.fuse_binaries([stage.to_binary()]), stage.to_binary())
    assert np.array_equal(jfuse.fuse_binaries([stage.to_binary()]), stage.to_binary())
    with pytest.raises(ValueError, match='empty'):
        tfuse.fuse_pipeline(Pipeline(()))
    with pytest.raises(ValueError, match='empty'):
        jfuse.fuse_pipeline(JPipeline(()))


def test_pipeline_methods_match_jax(workloads, tmp_path):
    port, ref = workloads['transformer_block']
    for attr in ('inp_latency', 'inp_shifts', 'out_qint', 'out_shift', 'out_neg', 'reg_bits', 'shape', 'latency'):
        assert getattr(port, attr) == getattr(ref, attr), attr
    assert port.solutions == port.stages
    for st, rst in zip(port.stages, ref.stages):
        assert np.array_equal(st.out_kifs, rst.out_kifs) and st.inp_latency == rst.inp_latency
        assert np.array_equal(st.ref_count, rst.ref_count)
    assert port.to_dict() == ref.to_dict()
    port.save(tmp_path / 'pipe.json')
    back = Pipeline.load(tmp_path / 'pipe.json')
    assert [s.to_binary().tobytes() for s in back.stages] == [s.to_binary().tobytes() for s in port.stages]
    port.stages[0].save_binary(tmp_path / 'stage.bin')
    assert np.array_equal(np.fromfile(tmp_path / 'stage.bin', dtype=np.int32), ref.stages[0].to_binary())
