"""Frontier rankers for the beam search.

A ranker orders candidate beam children (one applied substitution each) so
the frontier can be pruned back to ``beam`` states. Two implementations:

- :class:`CostRanker` (default, ``ranker='cost'``): the exact DAIS cost
  model — accumulated adder cost of the child state (cmvm/cost.py op costs)
  plus the cost of emitting the residual expressions as plain balanced
  adder trees right now (each output column with ``t`` terms needs ``t-1``
  adders). This is the true objective evaluated mid-trajectory, the ACT
  pattern of deriving the cost model from ISA-level op costs.

- :class:`LearnedRanker` (``ranker='/path/to/ranker.json'``): a tiny linear
  model over per-candidate features, trained offline by ``search/train.py``
  from solve traces (``DA4ML_SEARCH_TRACE_DIR``) to predict the final-cost
  delta of committing the candidate; lower predicted delta ranks first.

Both return "higher is better" scores; ties resolve by generation order
(deterministic: frontier-state-major, then heuristic rank).

Counterpart of ``da4ml_tpu/cmvm/search/ranker.py``; it loads the same
ranker files (``examples/search_traces/ranker.json``).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np

#: per-candidate feature vector, in order
FEATURE_NAMES = (
    'count',  # freq-map match count of the pair
    'overlap',  # n_overlap bit weight (wmc's quality signal)
    'latency_skew',  # |lat0 - lat1| of the operands
    'depth_remaining',  # beam rungs left before device handoff
    'novelty',  # 1 / (1 + times this exact pair was already taken this rung)
)


def candidate_features(count: float, overlap: float, latency_skew: float, depth_remaining: float, novelty: float):
    """Assemble one feature row (float64, FEATURE_NAMES order)."""
    return np.asarray([count, overlap, latency_skew, depth_remaining, novelty], dtype=np.float64)


@dataclass
class _Child:
    """One candidate expansion: the applied state + its ranking signals.

    ``cost_so_far`` is the summed DAIS cost of the CSE ops committed so far;
    ``tail_estimate`` the adder count of emitting the residual expressions
    as-is. ``order`` is the deterministic tie-break (generation order).
    """

    state: object
    feats: np.ndarray
    cost_so_far: float
    tail_estimate: float
    order: int
    meta: dict | None = None


def tail_estimate(state) -> float:
    """Adders needed to emit ``state`` with no further CSE: per output
    column, (terms - 1) tree adds over all residual digits."""
    total = 0.0
    for i_out in range(state.n_out):
        terms = 0
        for row in state.expr:
            terms += len(row[i_out])
        if terms > 1:
            total += terms - 1
    return total


class CostRanker:
    """Exact DAIS cost: lower (cost so far + tree-emission tail) is better."""

    name = 'cost'

    def scores(self, children: 'list[_Child]') -> np.ndarray:
        return np.asarray([-(c.cost_so_far + c.tail_estimate) for c in children], dtype=np.float64)


class LearnedRanker:
    """Linear probe over :data:`FEATURE_NAMES`, predicting final-cost delta.

    ``scores`` returns the negated prediction (lower predicted delta ranks
    first). Serialized as JSON so a trained ranker is a committed,
    diffable artifact (examples/search_traces/ranker.json).
    """

    name = 'learned'

    def __init__(self, weights, bias: float = 0.0, mean=None, std=None, feature_names=FEATURE_NAMES):
        self.weights = np.asarray(weights, dtype=np.float64)
        self.bias = float(bias)
        n = len(self.weights)
        self.mean = np.zeros(n) if mean is None else np.asarray(mean, dtype=np.float64)
        self.std = np.ones(n) if std is None else np.asarray(std, dtype=np.float64)
        self.feature_names = tuple(feature_names)
        if len(self.feature_names) != n or len(self.mean) != n or len(self.std) != n:
            raise ValueError('ranker weight/feature-name/normalization lengths disagree')

    def predict(self, feats: np.ndarray) -> np.ndarray:
        """Predicted final-cost delta per feature row (lower = better)."""
        X = np.atleast_2d(np.asarray(feats, dtype=np.float64))
        Xn = (X - self.mean) / np.where(self.std > 0, self.std, 1.0)
        return Xn @ self.weights + self.bias

    def folded(self) -> 'tuple[np.ndarray, float]':
        """The probe with its normalization folded in: ``(w, b)`` such that
        ``predict(X) == X @ w + b`` — the form the device prune scores
        (torch_beam ``prune``; the device evaluates it in f32, so
        tie-region fork choices may diverge from the host beam's f64)."""
        std = np.where(self.std > 0, self.std, 1.0)
        w = self.weights / std
        return w, float(self.bias) - float(self.mean @ w)

    def scores(self, children: 'list[_Child]') -> np.ndarray:
        if not children:
            return np.zeros(0)
        return -self.predict(np.stack([c.feats for c in children]))

    def to_dict(self) -> dict:
        return {
            'kind': 'linear',
            'feature_names': list(self.feature_names),
            'weights': [float(w) for w in self.weights],
            'bias': self.bias,
            'mean': [float(v) for v in self.mean],
            'std': [float(v) for v in self.std],
        }

    def save(self, path) -> None:
        blob = json.dumps(self.to_dict(), indent=1, sort_keys=True)
        tmp = f'{path}.tmp.{os.getpid()}'
        with open(tmp, 'w') as fh:
            fh.write(blob)
        os.replace(tmp, path)

    @classmethod
    def from_dict(cls, d: dict) -> 'LearnedRanker':
        if d.get('kind') != 'linear':
            raise ValueError(f'unsupported ranker kind {d.get("kind")!r}')
        return cls(d['weights'], d.get('bias', 0.0), d.get('mean'), d.get('std'), tuple(d['feature_names']))

    @classmethod
    def load(cls, path) -> 'LearnedRanker':
        with open(path) as fh:
            return cls.from_dict(json.load(fh))


def get_ranker(spec_ranker: str):
    """Resolve a SearchSpec ranker string: 'cost' or a LearnedRanker path."""
    if spec_ranker == 'cost':
        return CostRanker()
    return LearnedRanker.load(spec_ranker)
