"""The port's IR against the JAX package's: the binary format, the opcode
table, the level schedule, the synth generator and the reference
interpreter, on the same seeded programs. Tolerance is exact: bit-exactness
is the product contract."""

import numpy as np
import pytest

from da4ml_tpu.ir import dais_binary as jbin
from da4ml_tpu.ir import optable as jopt
from da4ml_tpu.ir import schedule as jsched
from da4ml_tpu.ir import synth as jsynth
from da4ml_tpu.runtime import reference as jref
from da4ml_tpu_torch.ir import dais_binary as tbin
from da4ml_tpu_torch.ir import optable as topt
from da4ml_tpu_torch.ir import schedule as tsched
from da4ml_tpu_torch.ir import synth as tsynth
from da4ml_tpu_torch.runtime import reference as tref


def _corpus(seed: int, n: int = 8):
    """``da4ml_tpu.ir.synth`` programs, every 4th wide (int64 path)."""
    rng = np.random.default_rng(seed)
    return [jsynth.random_program(rng, n_ops=120, n_in=5, n_out=4, wide=(k % 4 == 3)) for k in range(n)]


def _traced_jax_comb():
    from da4ml_tpu.trace import FixedVariableArrayInput, HWConfig, comb_trace

    rng = np.random.default_rng(3)
    inp = FixedVariableArrayInput(6, hwconf=HWConfig(1, -1, -1), solver_options={'backend': 'cpu'})
    x = inp.quantize(np.ones(6), np.full(6, 3), np.full(6, 2))
    w = rng.integers(-8, 8, (6, 4)).astype(np.float64)
    return comb_trace(inp, (x @ w).relu(i=np.full(4, 5), f=np.full(4, 2)))


def test_decode_accepts_jax_binary_unchanged():
    binary = _traced_jax_comb().to_binary()
    prog = tbin.decode(binary)
    jprog = jbin.decode(binary)
    for field in jprog._fields:
        a, b = getattr(prog, field), getattr(jprog, field)
        if field == 'tables':
            assert len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))
        else:
            assert np.array_equal(a, b), field
    assert np.array_equal(tbin.encode(prog), binary)


@pytest.mark.parametrize('seed', [0, 1])
def test_decode_roundtrip_synth_corpus(seed):
    for jprog in _corpus(seed):
        binary = jbin.encode(jprog)
        assert np.array_equal(tbin.encode(tbin.decode(binary)), binary)


def test_decode_rejects_corrupt_stream():
    binary = _traced_jax_comb().to_binary()
    with pytest.raises(ValueError):
        tbin.decode(binary[:-1])
    bad = binary.copy()
    bad[0] = 2
    with pytest.raises(ValueError):
        tbin.decode(bad)


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_reference_matches_jax_reference(seed):
    """The port's oracle equals the JAX package's on the synth corpus, wide
    programs included — outputs and the full int64 execution buffer."""
    rng = np.random.default_rng(100 + seed)
    for jprog in _corpus(seed):
        prog = tbin.decode(jbin.encode(jprog))
        data = jsynth.random_inputs(rng, jprog, 37)
        out, buf = tref.run_program(prog, data, return_buf=True)
        jout, jbuf = jref.run_program(jprog, data, return_buf=True)
        assert np.array_equal(out, jout)
        assert np.array_equal(buf, jbuf)


@pytest.mark.parametrize('wide', [False, True])
def test_port_synth_is_the_jax_generator(wide):
    """The port's copy of ``random_program`` draws the same program from the
    same seed, so a corpus carries across unchanged."""
    for seed in range(4):
        a = tsynth.random_program(np.random.default_rng(seed), n_ops=150, wide=wide)
        b = jsynth.random_program(np.random.default_rng(seed), n_ops=150, wide=wide)
        assert np.array_equal(tbin.encode(a), jbin.encode(b))
    assert tsynth.FAMILIES == jsynth.FAMILIES


def test_optable_rows_match_jax():
    assert [s.key for s in topt.OP_TABLE] == [s.key for s in jopt.OP_TABLE]
    for t, j in zip(topt.OP_TABLE, jopt.OP_TABLE):
        assert (t.opcodes, t.id0, t.reads_id1, t.cond_in_data, t.vector_class) == (
            j.opcodes, j.id0, j.reads_id1, j.cond_in_data, j.vector_class,
        )  # fmt: skip
        assert t.lower == j.pallas_lower  # the renamed column keeps the eleven names
        assert t.synth_family == j.synth_family
    assert topt.VECTOR_CLASS == jopt.VECTOR_CLASS
    assert set(topt.OPCODE_TO_SPEC) == set(jopt.OPCODE_TO_SPEC)


@pytest.mark.parametrize('seed', [0, 1])
def test_schedule_matches_jax(seed):
    for jprog in _corpus(seed, n=4):
        prog = tbin.decode(jbin.encode(jprog))
        key = np.array([topt.VECTOR_CLASS[int(o)] for o in prog.opcode])
        a = tsched.levelize_program(prog, sort_key=key)
        b = jsched.levelize_program(jprog, sort_key=key)
        for field in b._fields:
            assert np.array_equal(getattr(a, field), getattr(b, field)), field
        assert a.peak_live == b.peak_live and a.depth == b.depth
