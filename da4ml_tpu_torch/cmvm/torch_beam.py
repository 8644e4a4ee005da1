"""The device beam of the quality search: the fork/score/prune loop as torch
ops on the solve's device.

Counterpart of ``da4ml_tpu/cmvm/jax_search.py``'s device beam
(``_ForkSpec``, ``_build_fork_fn``, ``_build_prune_fn``, ``_learned_fold``,
``_device_beam_expand``, ``_expand_forks``), with no parked root carry and
no entry carry: the surviving forks go to the rung ladder as prefix lanes
(``torch_search.LanePrefix``).

A generation of the beam, for every unique eligible stage-0 lane of a
canonical (O, B) group:

- **fan-out**: each frontier slot's state (digits, qmeta, latency) is
  gathered into ``beam`` children, one index gather on the device;
- **fork** (:func:`fork_step`): each child ``k`` counts every pair of its
  small fork-phase state ([2, S, P, P], P = the group's input rows + depth,
  a power of two), takes the rank-``k`` candidate in host scan order
  (iterated host-order argmax, taken candidates masked out: rank ``r`` is
  ``heuristics.top_candidates(...)[r]``), commits it, and reports its
  ranking stats;
- **prune** (:func:`prune`): per source lane, novelty from the sibling
  decisions, the score ``-(cost + tail)`` (``CostRanker``) or the folded
  ``LearnedRanker`` probe, in f32 as the reference scores, and the best
  ``beam`` children by (score desc, generation order).

Only decision records, stats and the kept indices come back to the host,
which completes each surviving fork's prefix with
``search.beam.replay_fork_prefix`` (exact f64 metadata, trace features). The
result equals the host beam (``search.beam.expand_beam_lanes``) fork for
fork under ``CostRanker``.

Digits travel as int8: the reference's packed trit/byte fork format is an
upload saving of the TPU's and is not carried over.
"""

from __future__ import annotations

from dataclasses import dataclass
from math import inf

import numpy as np
import torch

from .. import telemetry
from ..parallel.shapes import canon_dim, next_pow2
from ..telemetry.obs import profile as _prof
from . import torch_search as ts
from .search.beam import replay_fork_prefix
from .search.ranker import get_ranker


@dataclass(frozen=True)
class _ForkSpec:
    """Shape class of one beam fork step: a single greedy substitution at a
    caller-chosen candidate rank, plus per-child ranking stats."""

    P: int  # fork-phase row capacity (root rows + beam depth, pow2)
    O: int
    B: int
    adder_size: int
    carry_size: int
    beam: int  # top-K candidates enumerated per frontier state


def _fork_bytes_per_child(spec: _ForkSpec) -> int:
    """Device bytes of one child in a fork step: the shifted digit stack and
    its abs copy, the pair counts and scores, the metadata planes."""
    P, O, B = spec.P, spec.O, spec.B
    return 8 * P * O * B * B + 64 * B * P * P + 16 * P * P + 4 * P * O * B


def fork_step(E, qm, lat, cur, meth, rank, cost_in, spec: _ForkSpec):
    """One fork of every child, on the tensors' device.

    Inputs: ``E`` int8 [N, P, O, B], ``qm`` f32 [N, P, 3], ``lat`` f32
    [N, P] (a child's own copies: updated in place), ``cur`` / ``meth`` /
    ``rank`` int32 [N] (``rank`` -1 marks a dead beam slot), ``cost_in``
    f32 [N] (the trajectory's accumulated DAIS cost).

    Returns ``(E, qm, lat, cur, rec int32 [N, 4], stats f32 [N, 8])``: the
    committed decision (zeros when none) and the stats (count, overlap,
    latency skew, op cost, tail, cost so far, took, valid). A
    frontier state with no candidate at all is carried through the pruning
    unchanged (rank 0 only), the host beam's drained branch. Stat values are
    integer-valued in practice, so exact in f32.
    """
    N, P, O, B = E.shape
    K = spec.beam
    dev = E.device
    meth = meth.to(torch.int64)
    rank = rank.to(torch.int64)
    Ef = E.to(torch.float32)
    sh = ts._shifted_up(Ef, B)  # [N, P, O, S, B]: sh[.., j, o, s, b] = E[.., j, o, b + s]
    A = torch.einsum('niob,njosb->nsij', Ef, sh)
    D = torch.einsum('niob,njosb->nsij', Ef.abs(), sh.abs())
    C = torch.stack([(D + A) * 0.5, (D - A) * 0.5], 1)  # [N, 2, S, P, P]
    del sh, A, D
    lo, hi, st = qm.unbind(-1)
    nov = ts._overlap_vec(lo[:, :, None], hi[:, :, None], st[:, :, None], lo[:, None], hi[:, None], st[:, None])
    dlt = (lat[:, :, None] - lat[:, None]).abs()  # [N, P, P]
    iot = torch.arange(P, device=dev)
    s_ax = torch.arange(B, device=dev)
    pair_ok = (s_ax[:, None, None] > 0) | (iot[None, :, None] < iot[None, None, :])  # [S, P, P]
    score = ts._score_cand(C, nov[:, None, None], dlt[:, None, None], meth.view(N, 1, 1, 1, 1), pair_ok[None, None])

    ar = torch.arange(N, device=dev)
    zero = torch.zeros(N, dtype=torch.int64, device=dev)
    found = torch.zeros(N, dtype=torch.bool, device=dev)
    sub, s, i, j = zero.clone(), zero.clone(), zero.clone(), zero.clone()
    any0 = found
    j_ax = iot.view(1, 1, 1, 1, P)
    for k in range(min(K, int(rank.max()) + 1) if N else 0):
        # per (sub, s, i) row, the best column (ties to the largest j: the
        # host key grows with j in a row), then the host-order argmax
        m = score.amax(-1)
        jb = torch.where((score == m[..., None]) & (m[..., None] != -inf), j_ax, -1).amax(-1)
        ok_k, sub_k, s_k, i_k, j_k = ts._dev_argmax_host_order(m, jb, P, B)
        i_k, j_k = i_k.clamp(0, P - 1), j_k.clamp(0, P - 1)  # meaningless where not ok_k
        sub_k, s_k = sub_k.clamp(0, 1), s_k.clamp(0, B - 1)
        if k == 0:
            any0 = ok_k
        take = (rank == k) & ok_k
        found = found | take
        sub, s = torch.where(take, sub_k, sub), torch.where(take, s_k, s)
        i, j = torch.where(take, i_k, i), torch.where(take, j_k, j)
        if k + 1 < K:
            hit = torch.nonzero(ok_k).flatten()
            score[hit, sub_k[hit], s_k[hit], i_k[hit], j_k[hit]] = -inf

    cnt_sel = C[ar, sub, s, i, j]
    nov_sel = nov[ar, i, j]
    dl_sel = dlt[ar, i, j]
    rec = torch.zeros((N, 4), dtype=torch.int32, device=dev)
    dcost = torch.zeros(N, dtype=torch.float32, device=dev)
    u = torch.nonzero(found).flatten()
    if u.numel():
        c = cur[u].to(torch.int64)
        E[u, c] = ts._dev_substitute(E, u, sub[u], s[u], i[u], j[u], B)
        qrow, nlat, rec_row, dc = ts._dev_commit_pair(qm, lat, u, sub[u], s[u], i[u], j[u], spec.adder_size,
                                                      spec.carry_size)  # fmt: skip
        qm[u, c] = qrow
        lat[u, c] = nlat
        rec[u] = rec_row
        dcost[u] = dc

    alive = rank >= 0
    took = found & alive
    valid = alive & (took | ((rank == 0) & ~any0))
    # residual adder-tree tail (search/ranker.py tail_estimate): per output
    # column, (terms - 1) tree adds over all surviving digits
    terms = (E != 0).sum((1, 3)).to(torch.float32)  # [N, O]
    tail = (terms - 1.0).clamp(min=0.0).sum(-1)
    zf = torch.zeros_like(dcost)
    # feature conventions follow heuristics._score: the mc family reports no
    # overlap weight, plain mc no latency skew either
    fcnt = torch.where(took, cnt_sel, zf)
    fnov = torch.where(took & (meth >= 3), nov_sel, zf)
    fdlt = torch.where(took & (meth != 0), dl_sel, zf)
    dtook = torch.where(took, dcost, zf)
    stats = torch.stack([fcnt, fnov, fdlt, dtook, tail, cost_in + dtook, took.float(), valid.float()], -1)
    return E, qm, lat, cur + took.to(cur.dtype), rec, stats


def prune(stats, rec, depth_rem: float, w, b, kind: str, K: int):
    """The frontier prune of one generation, per source lane: of its ``C``
    children (``stats`` f32 [G, C, 8], ``rec`` int32 [G, C, 4], generation
    order = child order), the best ``K`` by score, ties to the earlier
    child; returns their child indices int64 [G, K], -1 for empty slots.

    Novelty is derived here, since it needs the sibling decisions: 1 / (1 +
    times this exact pair was taken by an earlier child). ``kind='cost'``
    scores ``-(cost + tail)`` (``CostRanker``), ``kind='learned'`` the five
    ranker features against the folded ``LearnedRanker`` weights ``w`` f32
    [5], ``b`` f32, summed in feature order — both in f32, as the
    reference's device prune does.
    """
    G, C = stats.shape[:2]
    dev = stats.device
    cnt, novf, dlt = stats[..., 0], stats[..., 1], stats[..., 2]
    tail, cost = stats[..., 4], stats[..., 5]
    took = stats[..., 6] > 0.5
    valid = stats[..., 7] > 0.5
    same = (rec[:, :, None, :] == rec[:, None, :, :]).all(-1)  # [G, C, C]
    idx = torch.arange(C, device=dev)
    prior = idx[None, :] < idx[:, None]
    seen = (same & prior & took[:, None, :]).sum(-1).to(torch.float32)
    novelty = torch.where(took, 1.0 / (1.0 + seen), torch.zeros_like(seen))
    if kind == 'cost':
        score = -(cost + tail)
    else:
        feats = (cnt, novf, dlt, torch.full_like(cnt, depth_rem), novelty)
        acc = feats[0] * w[0]
        for f, wk in zip(feats[1:], w[1:]):
            acc = acc + f * wk
        score = -(acc + b)
    score = torch.where(valid, score, torch.full_like(score, -inf))
    v, order = torch.sort(score, dim=-1, descending=True, stable=True)
    v, order = v[:, :K], order[:, :K]
    return torch.where(v == -inf, -1, order)


def _learned_fold(ranker):
    """LearnedRanker.folded() cast for the device prune (f32)."""
    w, b = ranker.folded()
    return np.asarray(w, np.float32), np.float32(b)


def _root_state(ln, P_f: int, O: int, B: int):
    """A lane's search entry state in the fork phase's slot space: (E int8
    [P_f, O, B], qmeta f32 [P_f, 3], lat f32 [P_f]); unused rows zero digits,
    metadata (0, 0, 1) and latency 0."""
    ni, no, nb = ln.csd.shape
    E = np.zeros((P_f, O, B), np.int8)
    E[:ni, :no, :nb] = ln.csd
    q = np.zeros((P_f, 3), np.float32)
    q[:, 2] = 1.0
    lb = np.zeros((P_f,), np.float32)
    for i in range(ni):
        sf = 2.0 ** float(ln.shift0[i])
        qi = ln.qintervals[ln.slot(i)]
        lo, hi, stp = qi.min * sf, qi.max * sf, qi.step * sf
        if not all(np.isfinite(v) and abs(v) < 3e38 for v in (lo, hi, stp)):
            lo, hi, stp = 0.0, 0.0, 1.0
        q[i] = (lo, hi, stp)
        lb[i] = ln.latencies[ln.slot(i)]
    return E, q, lb


def _fork_chunked(gE, gq, gl, cur, meth, rank, cost, fspec: _ForkSpec):
    """:func:`fork_step` over the children in chunks that fit the device
    budget of a rung call (``torch_search.DEVICE_BUDGET``)."""
    N = gE.shape[0]
    step = max(1, ts.DEVICE_BUDGET // _fork_bytes_per_child(fspec))
    if N <= step:
        return fork_step(gE, gq, gl, cur, meth, rank, cost, fspec)
    parts = [fork_step(gE[a : a + step], gq[a : a + step], gl[a : a + step], cur[a : a + step], meth[a : a + step],
                       rank[a : a + step], cost[a : a + step], fspec) for a in range(0, N, step)]  # fmt: skip
    return tuple(torch.cat(ts_, 0) for ts_ in zip(*parts))


def _device_beam_expand(lanes: list, spec, adder_size: int, carry_size: int, device=None) -> list[tuple]:
    """Beam-expand the eligible stage-0 lanes with the fork/score/prune loop
    on ``device`` (the card when None; ``'cpu'`` runs the same torch ops on
    the CPU).

    Returns the host beam's contract ``[(lane_index, fork_lane, trace_meta),
    ...]``, fork for fork equal to ``search.beam.expand_beam_lanes`` under
    ``CostRanker``: unique source lanes (the host beam's memo key) expand
    once, and duplicates share their representative's forks.
    """
    dev = ts.resolve_device(device)
    ranker = get_ranker(spec.ranker)
    kind = 'cost' if getattr(ranker, 'name', '') == 'cost' else 'learned'
    w_np, b_np = _learned_fold(ranker) if kind == 'learned' else (np.zeros(5, np.float32), np.float32(0.0))
    w_eff = torch.as_tensor(w_np, device=dev)
    b_eff = torch.as_tensor(b_np, device=dev)

    K, depth = int(spec.beam), int(spec.depth)
    uniq: dict[tuple, int] = {}
    lane_rep: list[int] = []
    key_of: list = [None] * len(lanes)
    for idx, lane in enumerate(lanes):
        if lane.method == 'dummy':
            continue
        if lane.csd is None:
            ts._prepare_lane(lane)
        key = ts._lane_key(lane)
        key_of[idx] = key
        if key not in uniq:
            uniq[key] = len(lane_rep)
            lane_rep.append(idx)
    if not lane_rep:
        return []

    groups: dict[tuple[int, int], list[int]] = {}
    for g, idx in enumerate(lane_rep):
        ln = lanes[idx]
        groups.setdefault((canon_dim(ln.csd.shape[1], 8), canon_dim(ln.csd.shape[2], 2)), []).append(g)

    by_uniq: dict[int, list[tuple]] = {}
    n_forks_dev = n_prunes = 0
    for (O, B), gs in sorted(groups.items(), key=lambda it: (it[0][0] * it[0][1] ** 2, it[0]), reverse=True):
        G = len(gs)
        n_in_max = next_pow2(max(lanes[lane_rep[g]].csd.shape[0] for g in gs))
        P_f = next_pow2(n_in_max + depth)
        fspec = _ForkSpec(P_f, O, B, adder_size, carry_size, K)
        mcode_g = [ts._METHOD_CODES[lanes[lane_rep[g]].method] for g in gs]
        roots = [_root_state(lanes[lane_rep[g]], P_f, O, B) for g in gs]
        src = tuple(torch.as_tensor(np.stack(x)).to(dev) for x in zip(*roots))
        src_pos = {(x, 0): x for x in range(G)}

        # frontier bookkeeping (host): per (lane, slot) — cur, cost, and the
        # committed decision log [(rec, step, seen, rank), ...]
        frontier: list[list[dict | None]] = [[{'cur': n_in_max, 'cost': 0.0, 'log': []}] + [None] * (K - 1)
                                             for _ in range(G)]  # fmt: skip
        F = 1
        for t in range(depth):
            Cn = F * K
            sel = np.zeros((G * Cn,), np.int64)
            rank = np.full((G * Cn,), -1, np.int32)
            cur = np.full((G * Cn,), P_f, np.int32)
            meth = np.zeros((G * Cn,), np.int32)
            cost = np.zeros((G * Cn,), np.float32)
            for x in range(G):
                for f in range(F):
                    fr = frontier[x][f]
                    if fr is None:
                        continue
                    for k in range(K):
                        c = x * Cn + f * K + k
                        sel[c], rank[c], cur[c], meth[c], cost[c] = src_pos[(x, f)], k, fr['cur'], mcode_g[x], fr['cost']
            with _prof.annotate('cmvm.fork.fanout'):
                sel_t = torch.as_tensor(sel, device=dev)
                gE, gq, gl = (t_[sel_t] for t_ in src)  # the fan-out: one gather per state tensor
            with _prof.annotate('cmvm.fork.step'):
                outs = _fork_chunked(gE, gq, gl, *(torch.as_tensor(a, device=dev) for a in (cur, meth, rank, cost)),
                                     fspec)  # fmt: skip
            Ep2, q2, l2, _, rec_d, stats_d = outs
            with _prof.annotate('cmvm.fork.prune'):
                sel_k = prune(stats_d.view(G, Cn, 8), rec_d.view(G, Cn, 4), float(depth - t), w_eff, b_eff, kind, K)
            # the host sees only the decisions: records, stats, selections
            with _prof.annotate('cmvm.fork.fetch'):
                h_rec, h_stats, h_sel = rec_d.cpu().numpy(), stats_d.cpu().numpy(), sel_k.cpu().numpy()
            if telemetry.metrics_on():
                telemetry.counter('sched.upload_bytes').inc(sum(int(a.nbytes) for a in (sel, rank, cur, meth, cost)))
                telemetry.counter('sched.fetch_bytes').inc(int(h_rec.nbytes + h_stats.nbytes + h_sel.nbytes))

            new_frontier: list[list[dict | None]] = []
            new_pos: dict[tuple, int] = {}
            for x in range(G):
                # the host beam's `taken` count: how many earlier children
                # (generation order) committed the same exact pair
                seen_of = np.zeros((Cn,), np.int64)
                taken: dict[bytes, int] = {}
                for c0 in range(Cn):
                    c = x * Cn + c0
                    if h_stats[c, 6] > 0.5:
                        kk = h_rec[c].tobytes()
                        seen_of[c0] = taken.get(kk, 0)
                        taken[kk] = seen_of[c0] + 1
                n_valid = int((h_stats[x * Cn : (x + 1) * Cn, 7] > 0.5).sum())
                row: list[dict | None] = []
                kept = 0
                for f2 in range(K):
                    c0 = int(h_sel[x, f2])
                    if c0 < 0:
                        row.append(None)
                        continue
                    kept += 1
                    c = x * Cn + c0
                    parent = frontier[x][c0 // K]
                    entry = {'cur': int(cur[c]), 'cost': float(cost[c]), 'log': list(parent['log'])}
                    if h_stats[c, 6] > 0.5:
                        entry['cur'] += 1
                        entry['cost'] += float(h_stats[c, 3])
                        entry['log'].append((h_rec[c].copy(), t, int(seen_of[c0]), c0 % K))
                        n_forks_dev += 1
                    row.append(entry)
                    new_pos[(x, f2)] = c
                n_prunes += max(n_valid - kept, 0)
                new_frontier.append(row)
            frontier, src_pos, src = new_frontier, new_pos, (Ep2, q2, l2)
            F = K

        for x, g in enumerate(gs):
            ln = lanes[lane_rep[g]]
            shift_dn = n_in_max - ln.csd.shape[0]
            out_g: list[tuple] = []
            memo: dict = {}  # the replay's states, shared by this lane's forks
            for f2 in range(K):
                fr = frontier[x][f2]
                if fr is None or not fr['log']:
                    continue  # dead slot or no decision committed
                steps = []
                for rec, t, seen, rk in fr['log']:
                    id0, id1 = (int(v) - shift_dn if v >= n_in_max else int(v) for v in rec[:2])
                    steps.append(((id0, id1, int(rec[2]), int(rec[3])), t, seen, rk))
                out_g.append(replay_fork_prefix(ln, steps, depth, adder_size, carry_size, memo=memo))
            by_uniq[g] = out_g

    # reassemble in the host beam's lane-major order, duplicates sharing
    # their representative's expansion
    out: list[tuple] = []
    for idx, lane in enumerate(lanes):
        key = key_of[idx]
        if key is None:
            continue
        for pfx, meta in by_uniq.get(uniq[key], []):
            out.append((idx, ts._Lane(lane.kernel, lane.qintervals, lane.latencies, lane.method, perm=lane.perm,
                                      prefix=pfx), meta))  # fmt: skip
    ts.count_search(lanes_expanded=len(lane_rep), fork_lanes=len(out), device_forks=n_forks_dev,
                    device_prunes=n_prunes, frontier_culled=n_prunes)  # fmt: skip
    return out


def _expand_forks(lanes_sub: list, spec, adder_size: int, carry_size: int, device=None) -> list[tuple]:
    """Beam expansion of a stage-0 batch: the device beam on ``device``.
    There is no host fallback: the host beam (``search.beam``) is its
    parity oracle only."""
    with telemetry.span('cmvm.jax.fork', n_lanes=len(lanes_sub), beam=spec.beam, depth=spec.depth):
        return _device_beam_expand(lanes_sub, spec, adder_size, carry_size, device=device)
