"""Pair-selection heuristics for the greedy CSE loop.

All heuristics scan the frequency map in the reference's sorted Pair order
(id1, id0, sub, shift) with >=-argmax, so ties resolve identically to the
reference's flat-vector scan (indexers.cc). The sorted view is cached on the
state (``DAState.sorted_stat``) and maintained incrementally by
``state.update_stats``.

Methods: mc (most common), mc-dc / mc-pdc (latency-difference penalized),
wmc (bit-overlap weighted), wmc-dc / wmc-pdc.

Counterpart of ``da4ml_tpu/cmvm/heuristics.py`` without the beam-search
ranking (``top_candidates``), which the port does not carry yet.
"""

from __future__ import annotations

from .cost import overlap_and_accum
from .state import DAState, Pair

_NONE = Pair(-1, -1, False, 0)


def _sorted_items(state: DAState):
    cached = state.sorted_stat
    if cached is not None and len(cached) == len(state.freq_stat):
        return cached
    items = sorted(state.freq_stat.items(), key=lambda kv: kv[0].sort_key)
    state.sorted_stat = items
    return items


def idx_mc(state: DAState) -> Pair:
    best, max_freq = _NONE, 0
    for p, c in _sorted_items(state):
        if c >= max_freq:
            max_freq, best = c, p
    return best


def idx_mc_dc(state: DAState, absolute: bool) -> Pair:
    best = _NONE
    factor = 1e9
    max_score = 0.0 if absolute else float('-inf')
    for p, c in _sorted_items(state):
        lat0 = state.ops[p.id0].latency
        lat1 = state.ops[p.id1].latency
        score = c - factor * abs(lat0 - lat1)
        if score >= max_score:
            max_score, best = score, p
    return best


def idx_wmc(state: DAState) -> Pair:
    best, max_score = _NONE, 0
    for p, c in _sorted_items(state):
        n_overlap, _ = overlap_and_accum(state.ops[p.id0].qint, state.ops[p.id1].qint)
        score = c * n_overlap
        if score >= max_score:
            max_score, best = score, p
    return best


def idx_wmc_dc(state: DAState, absolute: bool) -> Pair:
    best = _NONE
    max_score = 0.0 if absolute else float('-inf')
    for p, c in _sorted_items(state):
        n_overlap, _ = overlap_and_accum(state.ops[p.id0].qint, state.ops[p.id1].qint)
        lat0 = state.ops[p.id0].latency
        lat1 = state.ops[p.id1].latency
        score = c * n_overlap - 256 * abs(lat0 - lat1)
        if score >= max_score:
            max_score, best = score, p
    return best


def select_pair(state: DAState, method: str) -> Pair:
    if method == 'mc':
        return idx_mc(state)
    if method == 'mc-dc':
        return idx_mc_dc(state, True)
    if method == 'mc-pdc':
        return idx_mc_dc(state, False)
    if method == 'wmc':
        return idx_wmc(state)
    if method == 'wmc-dc':
        return idx_wmc_dc(state, True)
    if method == 'wmc-pdc':
        return idx_wmc_dc(state, False)
    if method == 'dummy':
        return _NONE
    raise ValueError(f'Unknown method: {method}')
