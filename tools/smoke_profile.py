#!/usr/bin/env python3
"""``chip_smoke.py`` of a checkout, run with every module-level function of
it (and a few library entry points: the native and reference interpreters,
K2's plain version, ``RTLModel.predict`` and ``write``) wrapped in a
host-clock timer, so two checkouts' smoke runs can be held side by side.

    python3 tools/smoke_profile.py CHECKOUT OUT.json

``CHECKOUT`` is a directory holding a whole checkout (this one, or a parent
unpacked with ``git archive`` into ``build/``). The smoke run's own output
goes to stdout as usual and its exit code is this script's. At the end the
script writes ``OUT.json`` (total seconds, exit code, the start and length
of each phase function, and every timed name's calls and inclusive seconds,
largest first) and prints the same to stderr. A nested call counts in its
caller's seconds too; times of functions that run on several threads at
once add up past the wall time. Needs a CUDA device, as the smoke run does.
"""

from __future__ import annotations

import functools
import importlib.util
import json
import os
import sys
import time
import types

#: the phase functions whose start and length are listed in order
PHASES = {'check_corpus', 'run_dais_flagship', 'openmp_check', 'run_config5', 'run_fusion', 'run_wide_conv',
          'conversion_edges', 'run_pipeline_model', 'run_firmware', 'firmware_flagship', 'firmware_twin',
          'firmware_precondition'}  # fmt: skip


def run(root: str, out_path: str) -> int:
    os.chdir(root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location('chip_smoke', os.path.join(root, 'chip_smoke.py'))
    smoke = importlib.util.module_from_spec(spec)
    sys.modules['chip_smoke'] = smoke
    spec.loader.exec_module(smoke)
    stats: dict[str, list] = {}
    marks: list[tuple[str, float, float]] = []
    t_start = time.perf_counter()

    def wrap(name, fn):
        @functools.wraps(fn)
        def timed_fn(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                dt = time.perf_counter() - t0
                s = stats.setdefault(name, [0, 0.0])
                s[0] += 1
                s[1] += dt
                if name in PHASES:
                    marks.append((name, round(t0 - t_start, 2), round(dt, 2)))

        return timed_fn

    # the smoke run's functions look each other up in its module at call time
    for name, fn in list(vars(smoke).items()):
        if isinstance(fn, types.FunctionType) and fn.__module__ == 'chip_smoke' and name not in ('main', 'timed', 'counted'):
            setattr(smoke, name, wrap(name, fn))
    import da4ml_tpu_torch.cmvm.torch_search as ts
    import da4ml_tpu_torch.codegen.rtl.rtl_model as rtl_model
    import da4ml_tpu_torch.native as native
    import da4ml_tpu_torch.runtime.reference as reference

    native.run_binary = wrap('native.run_binary', native.run_binary)
    reference.run_program = wrap('reference.run_program', reference.run_program)
    ts.rung_plain = wrap('torch_search.rung_plain', ts.rung_plain)
    rtl_model.RTLModel.predict = wrap('RTLModel.predict', rtl_model.RTLModel.predict)
    rtl_model.RTLModel.write = wrap('RTLModel.write', rtl_model.RTLModel.write)
    rc = 1
    try:
        rc = smoke.main()
    finally:
        total = time.perf_counter() - t_start
        rows = sorted(stats.items(), key=lambda kv: -kv[1][1])
        with open(out_path, 'w') as f:
            json.dump({'total_s': total, 'rc': rc, 'marks': marks, 'stats': dict(rows)}, f, indent=1)
        print(f'smoke_profile: total {total:.1f} s', file=sys.stderr)
        for name, start, dt in marks:
            print(f'  {name}: starts {start} s, {dt} s', file=sys.stderr)
        for name, (calls, seconds) in rows[:40]:
            print(f'  {name}: {calls} calls, {seconds:.2f} s', file=sys.stderr)
    return rc


if __name__ == '__main__':  # the 'cpu' host solve's spawned workers import this file
    sys.exit(run(os.path.abspath(sys.argv[1]), os.path.abspath(sys.argv[2])))
