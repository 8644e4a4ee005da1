#!/usr/bin/env python3
"""The JAX package's quality-search results that ``chip_smoke.py``'s quality
phase holds the port to, computed on the CPU.

    JAX_PLATFORMS=cpu python3 tools/quality_digests.py [--skip-config5]

Prints one JSON object:

- ``flagship``: sha256 of the flagship's DAIS binary (little-endian int32;
  the program ``__graft_entry__._flagship_comb`` traces, which the port's
  ``flagship_comb()`` equals) traced with ``{'backend': 'jax', 'quality':
  q}`` for ``q`` in ``'fast'``, ``'search'`` and ``'max'``, with each
  program's cost and the seconds of each trace;
- ``corpus``: the costs of ``ci/quality_corpus.npz``'s kernels (sorted by
  name) solved by ``solve_jax_many`` at ``'fast'`` and at ``'search'``, and
  by the host oracle (``api.solve(backend='auto')``);
- ``config5``: the sha256 and cost of ``bench.py``'s config-5 model
  (``_trace_model(limited=False)``'s layers and weights) traced with
  ``{'backend': 'jax', 'quality': 'search'}``, and its seconds (left out with
  ``--skip-config5``);
- ``twin_cli``: ``chip_smoke.project_digest`` of the Verilog project the
  JAX package's ``convert`` writes for the config-5 twin
  (``da4ml_tpu_torch.models.config5_twin`` saved with ``torch.save``) with
  ``--solver-backend jax --quality search --inputs-kif 1 3 2 -n 0``, and its
  seconds.

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

QUALITIES = ('fast', 'search', 'max')


def digest(comb) -> str:
    return hashlib.sha256(comb.to_binary().astype('<i4').tobytes()).hexdigest()


def flagship(quality: str):
    """``__graft_entry__._flagship_comb`` with ``quality`` in its solver options."""
    import numpy as np

    from da4ml_tpu.trace import FixedVariableArrayInput, HWConfig, comb_trace

    rng = np.random.default_rng(20260729)
    opts = {'backend': 'jax', 'quality': quality}
    inp = FixedVariableArrayInput(16, hwconf=HWConfig(1, -1, -1), solver_options=opts)
    x = inp.quantize(np.ones(16), np.full(16, 3), np.full(16, 2))
    dims = [16, 32, 32, 5]
    for li in range(len(dims) - 1):
        x = x @ rng.integers(-8, 8, (dims[li], dims[li + 1])).astype(np.float64)
        if li < len(dims) - 2:
            x = x.relu(i=np.full(dims[li + 1], 5), f=np.full(dims[li + 1], 2))
    return comb_trace(inp, x)


def config5(quality: str):
    """``bench.py``'s config-5 model at full size with ``quality``."""
    import numpy as np

    import da4ml_tpu.trace.ops.conv_utils as cu
    from da4ml_tpu.trace import FixedVariableArrayInput, HWConfig, comb_trace

    rng = np.random.default_rng(5)
    side, cin, cmid, dense = 8, 3, 8, 32
    flat = (side // 2) ** 2 * cmid
    w1 = rng.integers(-32, 32, (3, 3, cin, cmid)).astype(np.float64)
    w2 = rng.integers(-32, 32, (flat, dense)).astype(np.float64)
    w3 = rng.integers(-32, 32, (dense, 5)).astype(np.float64)
    shape = (side, side, cin)
    opts = {'backend': 'jax', 'quality': quality}
    inp = FixedVariableArrayInput(shape, hwconf=HWConfig(1, -1, -1), solver_options=opts)
    x = inp.quantize(np.ones(shape), np.full(shape, 3), np.full(shape, 2))
    x = cu.conv2d(x, w1, padding='same')
    x = x.relu(i=np.full(x.shape, 6), f=np.full(x.shape, 2))
    x = cu.max_pool2d(x, 2).reshape(-1)
    x = (x @ w2).relu(i=np.full(dense, 7), f=np.full(dense, 2))
    return comb_trace(inp, x @ w3)


def corpus() -> dict:
    import numpy as np

    from da4ml_tpu.cmvm import api
    from da4ml_tpu.cmvm.jax_search import solve_jax_many

    with np.load(HERE / 'ci' / 'quality_corpus.npz') as blob:
        names = sorted(blob.files)
        kernels = [np.asarray(blob[k], np.float64) for k in names]
    t0 = time.perf_counter()
    fast = [float(s.cost) for s in solve_jax_many(kernels)]
    t1 = time.perf_counter()
    beam = [float(s.cost) for s in solve_jax_many(kernels, quality='search')]
    t2 = time.perf_counter()
    host = [float(api.solve(k, backend='auto').cost) for k in kernels]
    return {'names': names, 'fast': fast, 'search': beam, 'host': host, 'fast_s': t1 - t0, 'search_s': t2 - t1}


def twin_cli() -> dict:
    import torch

    from chip_smoke import project_digest
    from da4ml_tpu._cli import main as cli_main
    from da4ml_tpu_torch.models import config5_twin

    with tempfile.TemporaryDirectory() as tmp:
        pt = Path(tmp) / 'twin.pt'
        torch.save(config5_twin(), pt)
        t0 = time.perf_counter()
        rc = cli_main(['convert', str(pt), str(Path(tmp) / 'prj'), '--flavor', 'verilog', '--solver-backend', 'jax',
                       '--quality', 'search', '--inputs-kif', '1', '3', '2', '-n', '0', '-v', '0'])  # fmt: skip
        assert rc == 0, rc
        return {'verilog': project_digest(Path(tmp) / 'prj'), 'seconds': time.perf_counter() - t0}


def main() -> int:
    out: dict = {'flagship': {}}
    for q in QUALITIES:
        t0 = time.perf_counter()
        comb = flagship(q)
        out['flagship'][q] = {'sha256': digest(comb), 'cost': float(comb.cost), 'seconds': time.perf_counter() - t0}
        print(f'flagship {q}: {out["flagship"][q]}', file=sys.stderr, flush=True)
    out['corpus'] = corpus()
    print(f'corpus: {out["corpus"]}', file=sys.stderr, flush=True)
    out['twin_cli'] = twin_cli()
    print(f'twin_cli: {out["twin_cli"]}', file=sys.stderr, flush=True)
    if '--skip-config5' not in sys.argv[1:]:
        t0 = time.perf_counter()
        comb = config5('search')
        out['config5'] = {'sha256': digest(comb), 'cost': float(comb.cost), 'seconds': time.perf_counter() - t0}
    print(json.dumps(out))
    return 0


if __name__ == '__main__':
    sys.exit(main())
