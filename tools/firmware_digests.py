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
  trace.

This script imports both packages; it is a tool, not part of the port.
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
    print(json.dumps(out))
    return 0


if __name__ == '__main__':
    sys.exit(main())
