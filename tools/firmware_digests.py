#!/usr/bin/env python3
"""The JAX package's firmware digests that ``chip_smoke.py``'s firmware
phase holds the port to, computed on the CPU.

    JAX_PLATFORMS=cpu python3 tools/firmware_digests.py

Prints one JSON object:

- ``projects``: ``chip_smoke.project_digest`` of the HDL projects the JAX
  package writes for the flagship program (``__graft_entry__``'s, which the
  port's ``flagship_comb()`` equals byte for byte) with
  ``latency_cutoff=5``, Verilog and VHDL, ``register_layers`` 1, and the
  Verilog project of the config-5 twin's device-search trace
  (``twin_verilog``), also cut at latency 5;
- ``twin``: sha256 of the config-5 twin's DAIS binary
  (``da4ml_tpu_torch.models.config5_twin``, traced by the JAX package's
  ``trace_model`` with ``inputs_kif=(1, 3, 2)``) with its device search
  (``'jax'``) and with its native solver (``'cpp'``), and the seconds of each
  trace;
- ``hls``: ``project_digest`` of the HLS projects the JAX package's
  ``convert`` writes with its defaults (latency cutoff 5): the flagship
  program saved as ``.json``, in the ``vitis`` (``--flavor hls``),
  ``hlslib`` and ``oneapi`` flavours, and the config-5 twin saved with
  ``torch.save`` and converted with ``--solver-backend jax --inputs-kif 1 3
  2 -n 0`` (``twin_hls``: its trace with ``convert``'s ``hard_dc=2``), with
  the seconds of that conversion;
- ``verify``: sha256 of the standard output of the JAX package's ``verify
  corrupted.json --json``, run in the directory that holds the file, on
  the counterpart of ``chip_smoke.corrupted_mul_program()`` built with the
  JAX package's tracer and saved as ``corrupted.json``.

This script imports both packages; it is a tool, not part of the port. It
takes about 4.5 minutes on 8 host cores (x86_64), most of it the two
``'jax'`` traces of the twin (95 s with the trace's defaults, 128 s through
``convert``).
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))
os.environ.setdefault('JAX_PLATFORMS', 'cpu')


def main() -> int:
    from chip_smoke import FIRMWARE_CUTOFF, project_digest
    from da4ml_tpu.codegen import VerilogModel, VHDLModel
    from da4ml_tpu.converter import trace_model
    from da4ml_tpu.trace import HWConfig, comb_trace
    from da4ml_tpu_torch.models import CONFIG5_INPUTS_KIF, config5_twin

    import __graft_entry__

    out: dict = {'projects': {}, 'twin': {}}
    flagship = __graft_entry__._flagship_comb()
    combs = {}
    model = config5_twin()
    for backend in ('jax', 'cpp'):
        t0 = time.perf_counter()
        inp, y = trace_model(model, HWConfig(1, -1, -1), {'backend': backend}, inputs_kif=CONFIG5_INPUTS_KIF)
        combs[backend] = comb = comb_trace(inp, y)
        out['twin'][backend] = hashlib.sha256(comb.to_binary().astype('<i4').tobytes()).hexdigest()
        out['twin'][f'{backend}_s'] = time.perf_counter() - t0
        out['twin'][f'{backend}_ops'] = len(comb.ops)
    with tempfile.TemporaryDirectory() as tmp:
        for key, cls, comb in (('verilog', VerilogModel, flagship), ('vhdl', VHDLModel, flagship),
                               ('twin_verilog', VerilogModel, combs['jax'])):  # fmt: skip
            path = Path(tmp) / key
            cls(comb, 'model', path, latency_cutoff=FIRMWARE_CUTOFF).write()
            out['projects'][key] = project_digest(path)
    out['hls'] = hls_digests(project_digest, flagship, model)
    out['verify'] = verify_digest()
    print(json.dumps(out))
    return 0


def hls_digests(project_digest, flagship, model) -> dict:
    """The JAX package's ``convert`` of the flagship (.json) in each HLS
    flavour and of the twin (.pt) through its device search."""
    import torch

    from da4ml_tpu._cli.convert import convert

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        src = Path(tmp) / 'flagship.json'
        flagship.save(src)
        for flavor in ('hls', 'hlslib', 'oneapi'):
            convert(src, Path(tmp) / flavor, n_test_sample=0, flavor=flavor, verbose=0)
            out[flavor] = project_digest(Path(tmp) / flavor)
        pt = Path(tmp) / 'twin.pt'
        torch.save(model, pt)
        t0 = time.perf_counter()
        convert(pt, Path(tmp) / 'twin', n_test_sample=0, flavor='hls', solver_backend='jax', inputs_kif=(1, 3, 2),
                verbose=0)  # fmt: skip
        out['twin_hls_s'] = time.perf_counter() - t0
        out['twin_hls'] = project_digest(Path(tmp) / 'twin')
    return out


def verify_digest() -> str:
    """sha256 of ``verify corrupted.json --json``'s standard output."""
    import contextlib
    import io

    import numpy as np

    from da4ml_tpu._cli import main as cli_main
    from da4ml_tpu.ir import QInterval
    from da4ml_tpu.trace import FixedVariableArrayInput, HWConfig, comb_trace

    inp = FixedVariableArrayInput(4, hwconf=HWConfig(1, -1, -1), solver_options={'backend': 'cpp'})
    x = inp.quantize(np.ones(4), np.full(4, 3), np.full(4, 2))
    comb = comb_trace(inp, x[:2] * x[2:])
    ops = list(comb.ops)
    k = next(i for i, op in enumerate(ops) if op.opcode == 7)
    q = ops[k].qint
    ops[k] = ops[k]._replace(qint=QInterval(q.min / 64.0, q.max / 64.0, q.step))
    here = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        comb._replace(ops=ops).save(Path(tmp) / 'corrupted.json')
        buf = io.StringIO()
        os.chdir(tmp)
        try:
            with contextlib.redirect_stdout(buf):
                rc = cli_main(['verify', 'corrupted.json', '--json'])
        finally:
            os.chdir(here)
    assert rc == 1, rc
    return hashlib.sha256(buf.getvalue().encode()).hexdigest()


if __name__ == '__main__':
    sys.exit(main())
