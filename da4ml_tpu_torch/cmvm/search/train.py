"""Offline trainer for the learned beam ranker.

Fits a ridge-regularized linear probe over the solve-trace features
(search/trace.py) to predict ``final_cost_delta`` — the adder-cost change of
the trajectory that committed a candidate, relative to the greedy baseline.
Deterministic (closed-form normal equations, no RNG), numpy-only, so the
committed ranker artifact (examples/search_traces/ranker.json) reproduces
bit-for-bit from the committed traces::

    python -m da4ml_tpu_torch.cmvm.search.train examples/search_traces ranker.json

The trained model plugs into any solve via
``SearchSpec(..., ranker='ranker.json')``.

Counterpart of ``da4ml_tpu/cmvm/search/train.py``; run on
``examples/search_traces`` it writes the committed ``ranker.json`` byte for
byte.
"""

from __future__ import annotations

import sys

import numpy as np

from .ranker import FEATURE_NAMES, LearnedRanker
from .trace import load_trace_dir


def records_to_xy(records: list[dict]) -> tuple[np.ndarray, np.ndarray]:
    """Feature matrix / target vector from trace records (skips malformed)."""
    X, y = [], []
    nf = len(FEATURE_NAMES)
    for r in records:
        f = r.get('features')
        if not isinstance(f, list) or len(f) != nf:
            continue
        X.append([float(v) for v in f])
        y.append(float(r.get('final_cost_delta', 0.0)))
    if not X:
        raise ValueError('no usable trace records (need features + final_cost_delta)')
    return np.asarray(X, dtype=np.float64), np.asarray(y, dtype=np.float64)


def train_ranker(X: np.ndarray, y: np.ndarray, l2: float = 1.0) -> LearnedRanker:
    """Closed-form ridge fit on standardized features."""
    X = np.atleast_2d(np.asarray(X, dtype=np.float64))
    y = np.asarray(y, dtype=np.float64)
    if X.shape[0] != y.shape[0]:
        raise ValueError(f'X rows {X.shape[0]} != y rows {y.shape[0]}')
    mean = X.mean(axis=0)
    std = X.std(axis=0)
    std_safe = np.where(std > 0, std, 1.0)
    Xn = (X - mean) / std_safe
    bias = float(y.mean())
    yc = y - bias
    n_feat = Xn.shape[1]
    A = Xn.T @ Xn + l2 * np.eye(n_feat)
    w = np.linalg.solve(A, Xn.T @ yc)
    return LearnedRanker(w, bias=bias, mean=mean, std=std_safe)


def train_from_dir(trace_dirpath: str, l2: float = 1.0) -> LearnedRanker:
    X, y = records_to_xy(load_trace_dir(trace_dirpath))
    return train_ranker(X, y, l2=l2)


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) not in (2, 3):
        print('usage: python -m da4ml_tpu_torch.cmvm.search.train <trace_dir> <out.json> [l2]', file=sys.stderr)
        return 2
    l2 = float(argv[2]) if len(argv) == 3 else 1.0
    ranker = train_from_dir(argv[0], l2=l2)
    ranker.save(argv[1])
    print(f'trained linear ranker over {list(FEATURE_NAMES)} -> {argv[1]}')
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
