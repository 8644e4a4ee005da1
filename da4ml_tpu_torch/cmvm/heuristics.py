"""Pair-selection heuristics for the greedy CSE loop.

All heuristics scan the frequency map in the reference's sorted Pair order
(id1, id0, sub, shift) with >=-argmax, so ties resolve identically to the
reference's flat-vector scan (indexers.cc). The sorted view is cached on the
state (``DAState.sorted_stat``) and maintained incrementally by
``state.update_stats`` — a selection call re-sorts only when the cache is
stale (e.g. a freshly created state).

Methods: mc (most common), mc-dc / mc-pdc (latency-difference penalized),
wmc (bit-overlap weighted), wmc-dc / wmc-pdc.

``top_candidates`` exposes the same scoring as a ranked top-k list — the
expansion primitive of the host beam (cmvm/search/beam.py): element 0 is
exactly the pair ``select_pair`` would commit.

Counterpart of ``da4ml_tpu/cmvm/heuristics.py``.
"""

from __future__ import annotations

from .cost import overlap_and_accum
from .state import DAState, Pair

_NONE = Pair(-1, -1, False, 0)

#: methods whose running >=-argmax starts at 0.0, i.e. only candidates with a
#: non-negative score are ever selectable (the reference's 'absolute' flag —
#: plus mc/wmc, whose initial best of 0 has the same effect)
_ABSOLUTE = frozenset({'mc', 'wmc', 'mc-dc', 'wmc-dc'})


def _sorted_items(state: DAState):
    cached = state.sorted_stat
    if cached is not None and len(cached) == len(state.freq_stat):
        return cached
    items = sorted(state.freq_stat.items(), key=lambda kv: kv[0].sort_key)
    state.sorted_stat = items
    return items


def _score(state: DAState, p: Pair, c: int, method: str) -> tuple[float, int, float]:
    """(score, n_overlap, dlat) of one candidate under ``method``."""
    if method == 'mc':
        return float(c), 0, 0.0
    lat0 = state.ops[p.id0].latency
    lat1 = state.ops[p.id1].latency
    dlat = abs(lat0 - lat1)
    if method in ('mc-dc', 'mc-pdc'):
        return c - 1e9 * dlat, 0, dlat
    n_overlap, _ = overlap_and_accum(state.ops[p.id0].qint, state.ops[p.id1].qint)
    if method == 'wmc':
        return float(c * n_overlap), n_overlap, dlat
    if method in ('wmc-dc', 'wmc-pdc'):
        return c * n_overlap - 256.0 * dlat, n_overlap, dlat
    raise ValueError(f'Unknown method: {method}')


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


def top_candidates(state: DAState, method: str, k: int) -> list[tuple[Pair, int, float, int, float]]:
    """The ``k`` best selectable candidates: ``(pair, count, score, n_overlap,
    dlat)``, best first.

    Ranked by (score desc, scan key desc): the greedy loop's ``>=``-argmax
    over the ascending scan keeps the LAST maximum, so among equal scores the
    largest (id1, id0, sub, shift) key is the host-preferred pair — element 0
    is exactly ``select_pair(state, method)``. Candidates a method could
    never select (negative score under an absolute method) are excluded.
    """
    if method == 'dummy':
        return []
    floor = 0.0 if method in _ABSOLUTE else float('-inf')
    scored = []
    for p, c in _sorted_items(state):
        score, n_overlap, dlat = _score(state, p, c, method)
        if score >= floor:
            scored.append((score, p.sort_key, p, c, n_overlap, dlat))
    scored.sort(key=lambda t: (t[0], t[1]), reverse=True)
    return [(p, c, score, n_overlap, dlat) for score, _, p, c, n_overlap, dlat in scored[:k]]


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
