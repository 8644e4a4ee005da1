"""Solve-trace export: the learned ranker's training data.

When ``DA4ML_SEARCH_TRACE_DIR`` is set and a beam solve runs, every fork
trajectory that completed (host prefix + device tail + stage-1) is written
as JSONL records — one per committed beam decision::

    {"features": [count, overlap, latency_skew, depth_remaining, novelty],
     "chosen": true,            # was this the greedy argmax of its state?
     "final_cost_delta": -3.0,  # fork total cost - base greedy total cost
     "matrix": "9f32...",       # kernel content hash (group key)
     "dc": 2, "method": "wmc", "restart": 0, "step": 0}

``final_cost_delta < 0`` means the trajectory through this decision beat the
greedy baseline — exactly the signal ``search/train.py`` regresses the
features against. Files are uniquely named per (process, call), so parallel
campaigns can share one trace dir; records are self-contained.

Counterpart of ``da4ml_tpu/cmvm/search/trace.py``: the same variable, file
names and records.
"""

from __future__ import annotations

import hashlib
import json
import os

from ... import telemetry

#: env knob: directory to append solve-trace JSONL files to
TRACE_DIR_ENV = 'DA4ML_SEARCH_TRACE_DIR'


def trace_dir() -> str | None:
    d = os.environ.get(TRACE_DIR_ENV, '').strip()
    return d or None


_seq = [0]


def export_records(dirpath: str, records: list[dict]) -> str | None:
    """Append ``records`` as one JSONL file under ``dirpath``; returns the
    path (None when there was nothing to write). Failures are swallowed —
    trace export must never fail a solve."""
    if not records:
        return None
    try:
        os.makedirs(dirpath, exist_ok=True)
        _seq[0] += 1
        digest = hashlib.sha1(json.dumps(records[0], sort_keys=True).encode()).hexdigest()[:8]
        path = os.path.join(dirpath, f'trace_{digest}_{os.getpid()}_{_seq[0]}.jsonl')
        tmp = f'{path}.tmp'
        with open(tmp, 'w') as fh:
            for r in records:
                fh.write(json.dumps(r, sort_keys=True) + '\n')
        os.replace(tmp, path)
        telemetry.counter('search.trace_records').inc(len(records))
        return path
    except OSError:
        return None


def solve_records(kernels, exp_jobs, slot_ids, fork_meta, totals, base_totals) -> list[dict]:
    """Assemble trace records for one batched beam solve.

    ``exp_jobs[x] = (mi, dc, mp_idx, restart)`` per expanded lane,
    ``slot_ids[x]`` 0 for base lanes, ``fork_meta[x]`` the beam decision
    metadata (None for base lanes), ``totals[x]`` the lane's final two-stage
    cost, ``base_totals[(mi, dc, mp, r)]`` the matching base lane's cost.
    """
    out: list[dict] = []
    khash: dict[int, str] = {}
    for x, (mi, dc, mp, r) in enumerate(exp_jobs):
        meta = fork_meta[x]
        if not meta or slot_ids[x] == 0:
            continue
        base = base_totals.get((mi, dc, mp, r))
        if base is None:
            continue
        if mi not in khash:
            k = kernels[mi]
            khash[mi] = hashlib.sha1(str(k.shape).encode() + k.tobytes()).hexdigest()[:16]
        delta = float(totals[x]) - float(base)
        for step in meta:
            out.append(
                {
                    'features': step['features'],
                    'chosen': bool(step['chosen']),
                    'final_cost_delta': delta,
                    'matrix': khash[mi],
                    'dc': int(dc),
                    'method_pair': int(mp),
                    'restart': int(r),
                    'step': int(step['step']),
                }
            )
    return out


def load_trace_dir(dirpath: str) -> list[dict]:
    """Read every record of every ``trace_*.jsonl`` under ``dirpath``
    (sorted by filename for reproducibility)."""
    records: list[dict] = []
    for name in sorted(os.listdir(dirpath)):
        if not (name.startswith('trace_') and name.endswith('.jsonl')):
            continue
        with open(os.path.join(dirpath, name)) as fh:
            for line in fh:
                line = line.strip()
                if line:
                    records.append(json.loads(line))
    return records
