"""Decision-prefix beam expansion on the host: the device beam's parity oracle.

The greedy device loop commits one ``>=``-argmax substitution per step. The
beam instead explores the top-``beam`` substitutions of the first ``depth``
steps (the exact host machinery: ``create_state`` / ``update_state`` /
``heuristics.top_candidates``), prunes the frontier back to ``beam`` states
with a pluggable ranker, and converts each surviving trajectory into a
*decision-prefix lane*: the post-prefix digit tensor plus the committed op
records, which ``torch_search.solve_single_lanes`` resumes on the device
like a lane re-entering the rung ladder.

The search itself runs the device beam (``torch_beam._device_beam_expand``),
which must equal :func:`expand_beam_lanes` fork for fork under
``CostRanker``; :func:`replay_fork_prefix` completes the device beam's
forks on the host from their decision records. Counterpart of
``da4ml_tpu/cmvm/search/beam.py``.

Exactness: every fork is a valid CSE trajectory (host substitutions preserve
``sum_p expr[p] * buf[p] == kernel`` column-exactly), so the per-matrix
argmin over (base lane + forks) can only improve cost — the base greedy lane
always rides along unmodified.
"""

from __future__ import annotations

import numpy as np

from ... import telemetry
from ..heuristics import top_candidates
from ..state import DAState, create_state, to_shift, to_sign, update_state
from .ranker import _Child, candidate_features, get_ranker, tail_estimate
from .spec import SearchSpec


def _clone_state(st: DAState, stats: bool = True) -> DAState:
    """Fork a search state: per-trajectory containers copied, immutable
    payloads (kernel, row shifts, Op tuples, Pair keys) shared; with
    ``stats=False`` the pair statistics are left empty."""
    return DAState(
        shift0=st.shift0,
        shift1=st.shift1,
        expr=[[list(digits) for digits in row] for row in st.expr],
        n_bits=st.n_bits,
        ops=list(st.ops),
        freq_stat=dict(st.freq_stat) if stats else {},
        kernel=st.kernel,
        n_out=st.n_out,
        sorted_stat=list(st.sorted_stat) if (stats and st.sorted_stat is not None) else None,
    )


def _prefix_from_state(st: DAState, ni: int):
    """Flatten a forked trajectory into the torch_search ``LanePrefix``
    contract: post-prefix digit tensor (lane slot space: inputs 0..ni-1,
    prefix ops ni..ni+d-1), the committed (id0, id1, sub, shift) records,
    and f32 scoring metadata for the op rows."""
    from ..torch_search import LanePrefix

    d = len(st.ops) - ni
    E = np.zeros((ni + d, st.n_out, st.n_bits), dtype=np.int8)
    for p, row in enumerate(st.expr):
        for o, digits in enumerate(row):
            for v in digits:
                E[p, o, to_shift(v)] = to_sign(v)
    rec = np.asarray([[op.id0, op.id1, op.opcode, op.data] for op in st.ops[ni:]], dtype=np.int32).reshape(d, 4)
    qmeta = np.asarray([[op.qint.min, op.qint.max, op.qint.step] for op in st.ops[ni:]], dtype=np.float32).reshape(d, 3)
    lat = np.asarray([op.latency for op in st.ops[ni:]], dtype=np.float32)
    return LanePrefix(rec=rec, E=E, qmeta=qmeta, lat=lat)


def _expand_one(lane, spec: SearchSpec, ranker, adder_size: int, carry_size: int) -> list[tuple]:
    """Beam-expand one stage-0 lane; returns [(LanePrefix, trace_meta), ...]
    — one entry per surviving fork trajectory (the unforked base lane is NOT
    among them; it stays in the batch unchanged)."""
    from ..torch_search import count_search

    mat = np.ascontiguousarray(lane.kernel if lane.perm is None else lane.kernel[lane.perm], dtype=np.float64)
    ni = mat.shape[0]
    qints = [lane.qintervals[lane.slot(i)] for i in range(ni)]
    lats = [float(lane.latencies[lane.slot(i)]) for i in range(ni)]
    root = create_state(mat, qints, lats)
    base_cost = 0.0

    # frontier entries: (state, cost_so_far, trace meta per committed step)
    frontier: list[tuple[DAState, float, list[dict]]] = [(root, base_cost, [])]
    for t in range(spec.depth):
        with telemetry.span('cmvm.search.rung', step=t, frontier=len(frontier)):
            children: list[_Child] = []
            taken: dict[tuple, int] = {}
            order = 0
            for st, cost_so_far, meta in frontier:
                cands = top_candidates(st, lane.method, spec.beam)
                if not cands:
                    # drained trajectory: carry it through pruning unchanged
                    feats = candidate_features(0, 0, 0, spec.depth - t, 0.0)
                    children.append(_Child(st, feats, cost_so_far, tail_estimate(st), order, {'meta': meta}))
                    order += 1
                    continue
                for rank, (pair, cnt, _score, n_ov, dlat) in enumerate(cands):
                    seen = taken.get(pair, 0)
                    taken[pair] = seen + 1
                    child = _clone_state(st)
                    update_state(child, pair, adder_size, carry_size)
                    d_cost = float(child.ops[-1].cost)
                    feats = candidate_features(cnt, n_ov, dlat, spec.depth - t, 1.0 / (1.0 + seen))
                    step = {'features': [float(v) for v in feats], 'chosen': rank == 0, 'step': t}
                    children.append(_Child(child, feats, cost_so_far + d_cost, tail_estimate(child), order, {'meta': meta + [step]}))
                    order += 1
            scores = ranker.scores(children)
            keep = sorted(range(len(children)), key=lambda i: (-scores[i], children[i].order))[: spec.beam]
            count_search(frontier_culled=len(children) - len(keep))
            frontier = [(children[i].state, children[i].cost_so_far, children[i].meta['meta']) for i in keep]

    out = []
    for st, _cost, meta in frontier:
        if len(st.ops) == ni:  # no decision committed: identical to the base lane
            continue
        out.append((_prefix_from_state(st, ni), meta))
    return out


def replay_fork_prefix(lane, steps: list[tuple], depth: int, adder_size: int, carry_size: int, memo=None):
    """Reconstruct a device-forked trajectory's ``LanePrefix`` + trace meta
    from its fetched decision records.

    ``steps`` is ``[((id0, id1, sub, shift), rung, seen, rank), ...]`` in
    lane slot space. Each decision replays through the exact host state
    machinery (``create_state``/``update_state``, f64 metadata), and the
    trace features are re-derived from the pre-commit state with the same
    ``heuristics._score`` conventions the host beam records — so the
    resulting prefix and meta are byte-identical to what
    :func:`expand_beam_lanes` would have produced for the same decisions.
    The device fetches only the decisions; this replay is the O(decisions)
    host-side completion of the fork.

    ``memo`` (a dict, one per source lane) keeps the root state and each
    replayed decision prefix's state, so forks of one lane share them; the
    last decision of a fork updates only the digits and ops (its pair
    statistics are never read). The result is the same with or without it.
    """
    from ..heuristics import _score
    from ..state import Pair, update_expr

    mat = np.ascontiguousarray(lane.kernel if lane.perm is None else lane.kernel[lane.perm], dtype=np.float64)
    ni = mat.shape[0]
    memo = {} if memo is None else memo
    if () not in memo:
        qints = [lane.qintervals[lane.slot(i)] for i in range(ni)]
        lats = [float(lane.latencies[lane.slot(i)]) for i in range(ni)]
        memo[()] = create_state(mat, qints, lats)
    key: tuple = ()
    st = memo[key]
    meta: list[dict] = []
    for n, ((id0, id1, sub, shift), t, seen, rank) in enumerate(steps):
        pair = Pair(int(id0), int(id1), bool(sub), int(shift))
        c = st.freq_stat.get(pair, 0)
        _sc, n_ov, dlat = _score(st, pair, c, lane.method)
        feats = candidate_features(c, n_ov, dlat, depth - t, 1.0 / (1.0 + seen))
        meta.append({'features': [float(v) for v in feats], 'chosen': rank == 0, 'step': t})
        key += (pair,)
        if n + 1 == len(steps):  # the fork's state: digits and ops only
            st = _clone_state(st, stats=False)
            update_expr(st, pair, adder_size, carry_size)
        elif key in memo:
            st = memo[key]
        else:
            st = memo[key] = _clone_state(st)
            update_state(st, pair, adder_size, carry_size)
    return _prefix_from_state(st, ni), meta


def expand_beam_lanes(lanes, spec: SearchSpec, adder_size: int, carry_size: int) -> list[tuple]:
    """Beam-expand every eligible stage-0 lane of a device batch.

    Returns ``[(lane_index, fork_lane, trace_meta), ...]`` where each
    ``fork_lane`` is a new ``torch_search._Lane`` carrying a decision prefix.
    Byte-identical source lanes (the dc ladder repeats stage matrices at
    adjacent depths) expand once and share their fork prefixes.
    """
    from ..torch_search import _Lane

    from ..torch_search import count_search

    ranker = get_ranker(spec.ranker)
    memo: dict[tuple, list[tuple]] = {}
    out: list[tuple] = []
    n_expanded = 0
    for idx, lane in enumerate(lanes):
        if lane.method == 'dummy':
            continue
        key = (
            lane.kernel.tobytes(),
            lane.kernel.shape,
            lane.method,
            tuple(lane.qintervals),
            tuple(lane.latencies),
            None if lane.perm is None else lane.perm.tobytes(),
        )
        forks = memo.get(key)
        if forks is None:
            forks = _expand_one(lane, spec, ranker, adder_size, carry_size)
            memo[key] = forks
            n_expanded += 1
        for pfx, meta in forks:
            out.append((idx, _Lane(lane.kernel, lane.qintervals, lane.latencies, lane.method, perm=lane.perm, prefix=pfx), meta))
    count_search(lanes_expanded=n_expanded, fork_lanes=len(out))
    return out
