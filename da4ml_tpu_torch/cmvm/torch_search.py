"""The device CMVM search (``backend='torch'``): greedy CSE lanes on the card.

Counterpart of ``da4ml_tpu/cmvm/jax_search.py`` with its default ``top4``
select and its host-state rung loop. The search is expressed as tensors
with a leading lane axis:

- a lane's CSD expression set is a dense int8 tensor ``E[slot, out, bit]``
  with digits in {-1, 0, +1}; a slot is an input or a CSE intermediate;
- a per-(sub, shift, row) cache of the ``K`` best (score, column)
  candidates replaces the quadratic pair counts: a greedy step changes
  scores only for pairs touching rows {i, j, cur}, so those three rows are
  recounted exactly and every other row merges the three refreshed columns
  into its cache;
- lanes are (matrix, decompose depth, method, restart) searches; the rung
  ladder re-enters unfinished lanes at a larger slot budget ``P``.

``cse_rung`` is one rung, the stage-entry cache build and the greedy loop,
through ``fused_cse.greedy_loop``: on a CUDA tensor the hand-written kernel
``csrc/fused_cse.cu``, which builds the cache itself; on a CPU tensor its
plain version :func:`rung_plain` — the cache build in torch ops
(:func:`init_cache`), then :func:`greedy_plain`, a Python loop of batched
torch ops over the lanes. The host does CSD/kernel decomposition, adder-tree
emission and the argmin over candidates. When the native library builds
(``native.has_emit``), kernel decomposition is one
``decompose_batch`` call and each (O, B) group's finished lanes are emitted by
one ``emit_batch`` call as array-backed ``RawComb`` handles, of which only
the argmin's winners become ``CombLogic``s, as in the reference; otherwise
``kernel_decompose`` and ``_host_state_from`` + ``core.to_solution`` in
Python, which give the same solutions.

Determinism: ties resolve in the host solver's scan order (the largest
(id1, id0, sub, shift) key among maxima), so a single-lane search commits
the host solver's op sequence. The contract is ``Pipeline.kernel ==
kernel`` exactly.

Numerics: ``ceil(log2(x))`` is computed exactly from the float's exponent
(``torch.frexp``), and ``2**shift`` from its bits. XLA's CPU ``log2`` and
``exp2``, which the JAX package uses, are off by an ulp at some powers of two
(2^-13, 2^13, ...); the exact values are the host solver's.

``quality=`` (``'search'``, ``'max'``, a ``SearchSpec``) widens the sweep
with the spec's heuristic portfolio and restarts, folds the host solver in,
and forks stage-0 lanes into decision-prefix lanes (:class:`LanePrefix`)
with the device beam (``torch_beam``, torch ops on the solve's device); the
prefix lanes run the rung ladder beside the base lanes, through K2 with
full-capacity op records (``_KernelSpec.full_rec``).

Left out against the reference: the ``xla`` select, the device-resident
rung transitions and decision replay (the resident rung ladder: the
reference's ``_transition_jit``, ``_replay_digits``, ``_fork_seed_jit`` and
the ``park_roots``/``entry_carry`` hand-offs), prewarm, asynchronous
emission, meshes and multi-process code, and every environment knob but
the trace export's ``DA4ML_SEARCH_TRACE_DIR`` (their reference defaults are
the constants below).

Telemetry: the reference's spans (``cmvm.jax.solve_many``, ``.decompose``,
``.stage0``/``.stage1``, ``.csd``, ``.emit`` — the reference's names, so
traces of both packages compare) and its ``sched.*``, ``search.*`` and
``cse.*`` metrics, at their counterparts here; each K2 launch runs inside
``telemetry.obs.profile.annotate('cmvm.rung')``. The ``search.*`` counts
go through :func:`count_search`, which also keeps them in
:data:`search_stats`, read without telemetry.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from functools import lru_cache, wraps
from math import ceil, inf, log2

import numpy as np
import torch
import torch.nn.functional as F
from numpy.typing import NDArray

from .. import telemetry
from ..ir.comb import CombLogic, Pipeline
from ..ir.types import Op, QInterval, qint_add
from .. import native
from ..parallel.shapes import canon_dim, next_pow2
from ..runtime.torch_backend import resolve_device
from ..telemetry.obs import profile as _prof
from . import api as _host_api
from .core import solve_single, to_solution
from .cost import cost_add
from .csd import csd_decompose
from .decompose import kernel_decompose
from .state import DAState, encode_digit

_METHOD_CODES = {'mc': 0, 'mc-dc': 1, 'mc-pdc': 2, 'wmc': 3, 'wmc-dc': 4, 'wmc-pdc': 5, 'dummy': 6}

#: slot-count ceiling of the device search: lanes whose slot demand exceeds
#: it are solved on the host (the reference's top4 default)
PMAX = 32768
#: device-memory budget of one rung call in bytes; a rung whose lanes need
#: more runs in sequential chunks (the reference's default)
DEVICE_BUDGET = 4 << 30

#: 'over_budget_accepts' counts matrices where no candidate met the hard_dc
#: latency budget and the forced dc=-1 / wmc-dc terminal was accepted;
#: 'pmax_host_fallbacks' counts lanes routed to the host solver because their
#: slot demand exceeded PMAX. The rest are the reference's ``search.*``
#: telemetry of the quality search: 'beam_width' the last spec's beam (a
#: gauge), the others running counts — source lanes expanded, fork lanes
#: made, frontier children culled, device forks committed and pruned, and
#: matrices where the device result beat, tied or lost to the host solver
search_stats = {'over_budget_accepts': 0, 'pmax_host_fallbacks': 0, 'beam_width': 0, 'lanes_expanded': 0,
                'fork_lanes': 0, 'frontier_culled': 0, 'device_forks': 0, 'device_prunes': 0, 'strict_wins': 0,
                'ties': 0, 'host_rescues': 0}  # fmt: skip


def count_search(**counts: int) -> None:
    """Add each count to :data:`search_stats` and to the ``search.<name>``
    counter of the same name."""
    for name, n in counts.items():
        search_stats[name] += n
        telemetry.counter(f'search.{name}').inc(n)


_SP_FIN = -3.0e38  # finite stand-in for -inf in the cache merge's order


# --------------------------------------------------------------------------
# shared device math (tensors; scalars per lane broadcast from the left)
# --------------------------------------------------------------------------


def _pow2(shift: torch.Tensor) -> torch.Tensor:
    """Exact float32 ``2**shift`` of an integer tensor, from the exponent bits."""
    return ((shift.to(torch.int32) + 127) << 23).view(torch.float32)


def _ceil_log2(x: torch.Tensor) -> torch.Tensor:
    """``ceil(log2(x))`` of non-negative float32 values, exactly; -inf at 0."""
    m, e = torch.frexp(x)
    r = (e - (m == 0.5).to(e.dtype)).to(torch.float32)
    return torch.where(x == 0, -inf, r)


def _log2(x: torch.Tensor) -> torch.Tensor:
    """``log2`` of positive float32 values: exact at powers of two (the
    steps the search meets), ``torch.log2`` elsewhere."""
    m, e = torch.frexp(x)
    return torch.where(m == 0.5, (e - 1).to(torch.float32), torch.log2(x))


def _cost_add_vec(lo0, hi0, st0, lo1, hi1, st1, shift_pow, sub, adder_size: int, carry_size: int):
    """Vectorized cost_add (cost.py / state_opr.cc:31-67): (latency, cost)."""
    if adder_size < 0 and carry_size < 0:
        one = torch.ones_like(lo0)
        return one, one
    a_sz = 65535.0 if adder_size < 0 else float(adder_size)
    c_sz = 65535.0 if carry_size < 0 else float(carry_size)
    # sub swaps the endpoints WITHOUT negation (reference state_opr.cc:48-49)
    min1 = torch.where(sub, hi1, lo1)
    max1 = torch.where(sub, lo1, hi1)
    min1, max1, st1s = min1 * shift_pow, max1 * shift_pow, st1 * shift_pow
    max0 = hi0 + st0
    max1 = max1 + st1s
    f = -_log2(torch.maximum(st0, st1s))
    i = _ceil_log2(torch.maximum(torch.maximum(lo0.abs(), min1.abs()), torch.maximum(max0.abs(), max1.abs())))
    k = ((lo0 < 0) | (lo1 < 0)).to(f.dtype)
    n_accum = k + i + f
    return torch.ceil(n_accum / c_sz), torch.ceil(n_accum / a_sz)


def _iceil_log2(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x > 0, _ceil_log2(torch.clamp(x, min=1e-37)), 0.0)


def _overlap_vec(lo0, hi0, st0, lo1, hi1, st1):
    """Vectorized overlap_and_accum -> n_overlap (indexers.cc:36-56)."""
    max0 = hi0 + st0
    max1 = hi1 + st1
    f = -_iceil_log2(torch.maximum(st0, st1))
    i_low = _iceil_log2(torch.minimum(torch.maximum(lo0.abs(), max0.abs()), torch.maximum(lo1.abs(), max1.abs())))
    k = ((lo0 < 0) | (lo1 < 0)).to(f.dtype)
    return k + i_low + f


def _score_cand(cnt, nov, dlat, method, pair_ok):
    """Candidate scores of each selection method, invalid ones -inf."""
    base_mc = cnt
    base_wmc = cnt * nov
    score = torch.where(
        method == 0,
        base_mc,
        torch.where(
            method == 1,
            base_mc - 1e9 * dlat,
            torch.where(
                method == 2,
                base_mc - 1e9 * dlat,
                torch.where(method == 3, base_wmc, base_wmc - 256.0 * dlat),
            ),
        ),
    )
    valid = (cnt >= 2.0) & pair_ok
    absolute = (method == 1) | (method == 3) | (method == 4)
    valid &= torch.where(absolute, score >= 0, True)
    return torch.where(valid, score, -inf)


def _topk_scan(vals: torch.Tensor, k: int):
    """Exact (score desc, col desc) top-k along the last axis; -inf entries
    come out as (-inf, -1).

    Within one cache row the host scan key is increasing in the column, so
    col-desc ties realize the host's ``>=`` scan. ``torch.topk`` promises no
    tie order, so this is a stable descending sort of the reversed axis.
    """
    n = vals.shape[-1]
    v, pos = torch.sort(vals.flip(-1), dim=-1, descending=True, stable=True)
    v, pos = v[..., :k], pos[..., :k]
    cols = (n - 1 - pos).to(torch.int32)
    return v, torch.where(v == -inf, -1, cols)


def _merge_topk(v: torch.Tensor, c: torch.Tensor, k: int):
    """Top-k of a short candidate list by (score desc, col desc, index asc),
    scores compared with -inf as ``_SP_FIN``; dead entries -> (-inf, -1)."""
    n = v.shape[-1]
    vf = torch.clamp(v, min=_SP_FIN)
    v1, v2 = vf[..., :, None], vf[..., None, :]
    c1, c2 = c[..., :, None], c[..., None, :]
    idx = torch.arange(n, device=v.device)
    i1, i2 = idx[:, None], idx[None, :]
    first = (v1 > v2) | ((v1 == v2) & ((c1 > c2) | ((c1 == c2) & (i1 < i2))))
    pos = first.sum(-2)  # entries beating each: a permutation of 0..n-1
    order = torch.argsort(pos, dim=-1)[..., :k]
    out_v = vf.gather(-1, order)
    out_c = c.gather(-1, order)
    dead = out_v <= _SP_FIN
    return torch.where(dead, -inf, out_v), torch.where(dead, -1, out_c)


def _dev_rank_parts(sub, s, i, j, P: int, B: int):
    """The host scan-order rank of candidate (sub, s, i, j), split into an
    id-major part and a (sub, shift) minor part.

    The host heuristics scan the freq map sorted by (id1, id0, sub, shift)
    ascending and update on ``>=``, so among equal scores the LARGEST key
    wins. id1 = max(i, j), id0 = min(i, j); shift = +s when i < j else -s.
    """
    id0 = torch.minimum(i, j)
    id1 = torch.maximum(i, j)
    shift = torch.where(i < j, s, -s)
    return id1 * P + id0, sub * (2 * B + 1) + shift + B


def _dev_rank_decode(major, minor, P: int, B: int):
    """Invert :func:`_dev_rank_parts` back to (sub, s, i, j)."""
    id1 = torch.div(major, P, rounding_mode='floor')
    id0 = major - id1 * P
    sub = torch.div(minor, 2 * B + 1, rounding_mode='floor')
    shift = minor - sub * (2 * B + 1) - B
    i = torch.where(shift >= 0, id0, id1)
    j = torch.where(shift >= 0, id1, id0)
    return sub, shift.abs(), i, j


def _dev_argmax_host_order(tv0: torch.Tensor, tc0: torch.Tensor, P: int, B: int):
    """Per lane, the candidate of the rank-0 cache entries ``tv0/tc0
    [n, 2, B, P]`` with the max score, ties to the largest (id1, id0, sub,
    shift) key — a three-pass reduce (max score, max id-major, max minor).
    Returns (any valid, sub, s, i, j), each [n] int64."""
    n = tv0.shape[0]
    dev = tv0.device
    sub_ax = torch.arange(2, device=dev).view(1, 2, 1, 1)
    s_ax = torch.arange(B, device=dev).view(1, 1, B, 1)
    i_ax = torch.arange(P, device=dev).view(1, 1, 1, P)
    major, minor = _dev_rank_parts(sub_ax, s_ax, i_ax, tc0.to(torch.int64), P, B)
    flat = tv0.reshape(n, -1)
    m = flat.amax(1)
    tie = flat == m[:, None]
    r1 = torch.where(tie, major.reshape(n, -1), -1).amax(1)
    tie &= major.reshape(n, -1) == r1[:, None]
    r2 = torch.where(tie, minor.expand(n, 2, B, P).reshape(n, -1), -1).amax(1)
    return (m != -inf, *_dev_rank_decode(r1, r2, P, B))


def _dev_substitute(E: torch.Tensor, u, sub, s, i, j, B: int) -> torch.Tensor:
    """Substitute pair (row i bit b) + ±(row j bit b+s) in lanes ``u`` of
    ``E`` [N, P, O, B] in place; returns the new rows [n, O, B] placed at
    their anchor bits.

    For i == j a sequential scan over bits reproduces the host's
    ascending-bit greedy chain matching (state_opr.cc:249-280).
    """
    n = u.numel()
    ar = torch.arange(n, device=E.device)
    b_idx = torch.arange(B, device=E.device)
    row_i = E[u, i]  # [n, O, B]
    row_j = E[u, j]
    up = b_idx[None, :] + s[:, None]  # [n, B]: bit b + s
    in_range = up < B
    gat = torch.clamp(up, max=B - 1)[:, None, :].expand_as(row_j)
    shifted_j = torch.where(in_range[:, None, :], row_j.gather(2, gat), 0)
    target = torch.where(sub == 1, -1, 1)[:, None, None]
    sign_ok = (row_i != 0) & (shifted_j != 0) & (row_i.to(torch.int32) * shifted_j.to(torch.int32) == target)

    # i == j: digits can chain (b, b+s, b+2s); greedily match ascending
    avail = row_i != 0
    matched = torch.zeros_like(avail)
    for b in range(B):
        nxt = torch.clamp(b + s, max=B - 1)  # [n]
        ok_b = in_range[:, b, None]  # [n, 1]
        partner = ok_b & avail[ar, :, nxt]
        ok = sign_ok[:, :, b] & avail[:, :, b] & partner
        avail[:, :, b] &= ~ok
        avail[ar, :, nxt] = torch.where(ok_b, avail[ar, :, nxt] & ~ok, avail[ar, :, nxt])
        matched[:, :, b] = ok

    M = torch.where((i == j)[:, None, None], matched, sign_ok)
    dn = b_idx[None, :] - s[:, None]  # bit b - s
    gat_dn = torch.clamp(dn, min=0)[:, None, :].expand_as(M)
    M_up = (dn >= 0)[:, None, :] & M.gather(2, gat_dn)
    E[u, i] = torch.where(M, 0, row_i).to(torch.int8)
    row_j2 = E[u, j]  # re-read: if i == j this is the cleared row
    E[u, j] = torch.where(M_up, 0, row_j2).to(torch.int8)
    # anchor: id0 = i if i < j (digit at b), else j (digit at b+s); i == j
    # takes the high-bit anchor (the host's same-row pair convention)
    anchor_lo = torch.where(M, row_i, 0)
    anchor_hi = torch.where(M_up, row_j, 0)
    return torch.where((i < j)[:, None, None], anchor_lo, anchor_hi).to(torch.int8)


def _dev_commit_pair(qm, lat, u, sub, s, i, j, adder_size: int, carry_size: int):
    """Metadata of committing one pair per lane: (qmeta row [n, 3], latency
    [n], op record [n, 4] int32, op cost [n]). qint_add(q0, q1, shift,
    sub0=False, sub1=sub) in f32 — for scoring only; the host re-derives op
    metadata in f64 from the records."""
    id0 = torch.minimum(i, j)
    id1 = torch.maximum(i, j)
    shift = torch.where(i < j, s, -s)
    sp = _pow2(shift)
    q0, q1 = qm[u, id0], qm[u, id1]
    lo0, hi0, st0 = q0.unbind(-1)
    lo1, hi1, st1 = q1.unbind(-1)
    is_sub = sub == 1
    dlat, dcost = _cost_add_vec(lo0, hi0, st0, lo1, hi1, st1, sp, is_sub, adder_size, carry_size)
    nlat = torch.maximum(lat[u, id0], lat[u, id1]) + dlat
    min1 = torch.where(is_sub, -hi1, lo1) * sp
    max1 = torch.where(is_sub, -lo1, hi1) * sp
    qrow = torch.stack([lo0 + min1, hi0 + max1, torch.minimum(st0, st1 * sp)], -1)
    rec_row = torch.stack([id0, id1, sub, shift], -1).to(torch.int32)
    return qrow, nlat, rec_row, dcost


# --------------------------------------------------------------------------
# one rung: stage-entry cache build + the greedy loop
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class _KernelSpec:
    P: int  # total slots (inputs + max CSE intermediates)
    O: int  # outputs
    B: int  # CSD bit planes
    adder_size: int
    carry_size: int
    R_in: int = 0  # rows carrying state at rung entry (0 = full P); sizes the op records
    topk: int = 8  # score-cache depth per (sub, shift, row)
    #: full-capacity op records [P, 4]: beam-fork lanes enter a rung with
    #: heterogeneous cur0 (each prefix has its own depth), so the trimmed
    #: capacity's cur0 >= R_in invariant does not hold
    full_rec: bool = False

    @property
    def n_iters(self) -> int:
        """Op-record capacity: a rung adds at most P - cur0 ops, cur0 >= R_in
        (any cur0 >= 0 with ``full_rec``)."""
        return self.P - self.R_in if (self.R_in and not self.full_rec) else self.P


def _shifted_up(x: torch.Tensor, B: int) -> torch.Tensor:
    """sh[..., s, b] = x[..., b + s] (zero beyond B): [..., B] -> [..., S, B]."""
    return torch.stack([F.pad(x, (0, s))[..., s:] for s in range(B)], dim=-2)


def _shifted_down(x: torch.Tensor, B: int) -> torch.Tensor:
    """sh[..., s, b] = x[..., b - s] (zero below 0): [..., B] -> [..., S, B]."""
    return torch.stack([F.pad(x, (s, 0))[..., :B] for s in range(B)], dim=-2)


def _row_col_counts(Ef: torch.Tensor, Er: torch.Tensor, B: int):
    """Exact pair counts touching rows ``Er`` [n, 3, O, B] in ``Ef`` [n, P, O, B].

    rowC[n, k, s, r, p]: pairs (row r first operand at bit b, p second at
    b + s); colC[n, k, s, p, r]: pairs (p first, row r second); k = 0 add,
    1 sub — the reference's dirty-row ``update_stats`` (state_opr.cc:285-345)."""
    down = _shifted_down(Er, B)  # [n, 3, O, S, B]
    up = _shifted_up(Er, B)
    Ea = Ef.abs()
    A1 = torch.einsum('nrosb,npob->nsrp', down, Ef)
    D1 = torch.einsum('nrosb,npob->nsrp', down.abs(), Ea)
    A2 = torch.einsum('npob,nrosb->nspr', Ef, up)
    D2 = torch.einsum('npob,nrosb->nspr', Ea, up.abs())
    rowC = torch.stack([(D1 + A1) * 0.5, (D1 - A1) * 0.5], 1)
    colC = torch.stack([(D2 + A2) * 0.5, (D2 - A2) * 0.5], 1)
    return rowC, colC


def _meta_rows(qm: torch.Tensor, lat: torch.Tensor, R: torch.Tensor):
    """(n_overlap, |dlat|) of rows R [n, 3] against all slots: [n, 3, P] each
    (symmetric, so they serve R as first or as second operand)."""
    lo, hi, st = qm.unbind(-1)  # [n, P]
    loR, hiR, stR, laR = (t.gather(1, R) for t in (lo, hi, st, lat))
    nov = _overlap_vec(loR[:, :, None], hiR[:, :, None], stR[:, :, None], lo[:, None], hi[:, None], st[:, None])
    return nov, (laR[:, :, None] - lat[:, None]).abs()


def init_cache(E: torch.Tensor, qm: torch.Tensor, lat: torch.Tensor, method: torch.Tensor, K: int):
    """The top-K score cache ``(tv f32, tc int32)`` [N, 2, B, P, K] of every
    row, from one blocked pass over all pairs (the full [2, B, P, P] score
    tensor is never materialized)."""
    N, P, O, B = E.shape
    dev = E.device
    Ef = E.to(torch.float32)
    sh = _shifted_up(Ef, B)  # [N, P, O, S, B]
    sha = sh.abs()
    Efa = Ef.abs()
    lo, hi, st = qm.unbind(-1)
    iot = torch.arange(P, device=dev)
    s_rng = torch.arange(B, device=dev)
    meth = method.to(torch.int64).view(N, 1, 1, 1, 1)
    blk = next(b for b in (128, 64, 32, 16, 8, 4, 2, 1) if P % b == 0)
    tvs, tcs = [], []
    for r0 in range(0, P, blk):
        rs = slice(r0, r0 + blk)
        A = torch.einsum('niob,njosb->nsij', Ef[:, rs], sh)
        D = torch.einsum('niob,njosb->nsij', Efa[:, rs], sha)
        cnt = torch.stack([(D + A) * 0.5, (D - A) * 0.5], 1)  # [N, 2, S, blk, P]
        nov = _overlap_vec(lo[:, rs, None], hi[:, rs, None], st[:, rs, None], lo[:, None], hi[:, None], st[:, None])
        dlt = (lat[:, rs, None] - lat[:, None]).abs()
        ok = (s_rng[:, None, None] > 0) | (iot[rs][None, :, None] < iot[None, None, :])  # [S, blk, P]
        sc = _score_cand(cnt, nov[:, None, None], dlt[:, None, None], meth, ok[None, None])
        tvb, tcb = _topk_scan(sc, K)
        tvs.append(tvb)
        tcs.append(tcb)
    return torch.cat(tvs, 3).contiguous(), torch.cat(tcs, 3).contiguous()


def greedy_plain(E, qm, lat, tv, tc, cur, method, spec: _KernelSpec):
    """K2's plain version: the whole greedy CSE loop of every lane as a
    Python loop of batched torch ops, frozen lanes masked.

    State: ``E`` int8 [N, P, O, B], ``qm`` f32 [N, P, 3] (lo, hi, step),
    ``lat`` f32 [N, P], cache ``tv`` f32 / ``tc`` int32 [N, 2, B, P, K],
    ``cur`` int32 [N] (next free slot, = cur0), ``method`` int32 [N].
    Returns (E, qm, lat, op records int32 [N, n_iters, 4], cur int32 [N]):
    the state ``E, qm, lat, tv, tc, cur`` is updated in place and returned,
    as K2 does.

    A lane iterates while it has a valid candidate and ``cur < P``; a lane
    at ``cur == P`` is frozen (it resumes at the next rung with a fresh
    cache), and a padding lane enters at ``cur == P``.
    """
    P, B, K = spec.P, spec.B, spec.topk
    dev = E.device
    cur_io = cur
    cur = cur.to(torch.int64)
    cur0 = cur.clone()
    meth = method.to(torch.int64)
    N = E.shape[0]
    rec = torch.zeros((N, spec.n_iters, 4), dtype=torch.int32, device=dev)
    go = torch.ones(N, dtype=torch.bool, device=dev)
    iot = torch.arange(P, device=dev)
    s_ax = torch.arange(B, device=dev)[None, :, None, None]
    pick_j = torch.tensor([False, True, False], device=dev)
    while True:
        act = torch.nonzero(go & (cur < P)).flatten()
        if act.numel() == 0:
            break
        anyv, sub, s, i, j = _dev_argmax_host_order(tv[act, ..., 0], tc[act, ..., 0], P, B)
        go[act] = anyv
        keep = torch.nonzero(anyv).flatten()
        if keep.numel() == 0:
            continue
        u = act[keep]
        sub, s, i, j = sub[keep], s[keep], i[keep], j[keep]
        n = u.numel()
        ar = torch.arange(n, device=dev)
        c = cur[u]

        new_row = _dev_substitute(E, u, sub, s, i, j, B)
        E[u, c] = new_row
        qrow, nlat, rec_row, _ = _dev_commit_pair(qm, lat, u, sub, s, i, j, spec.adder_size, spec.carry_size)
        qm[u, c] = qrow
        lat[u, c] = nlat
        rec[u, c - cur0[u]] = rec_row

        # exact cache maintenance for the three dirty rows / columns
        R = torch.stack([i, j, c], 1)  # [n, 3]
        Ef = E[u].to(torch.float32)
        rowC, colC = _row_col_counts(Ef, Ef[ar[:, None], R], B)
        novR, dltR = _meta_rows(qm[u], lat[u], R)
        m5 = meth[u].view(n, 1, 1, 1, 1)
        okR = (s_ax > 0) | (R[:, None, :, None] < iot)  # [n, S, 3, P]
        rowS = _score_cand(rowC, novR[:, None, None], dltR[:, None, None], m5, okR[:, None])
        okC = (s_ax > 0) | (iot[None, None, :, None] < R[:, None, None, :])  # [n, S, P, 3]
        novC, dltC = novR.transpose(1, 2), dltR.transpose(1, 2)
        colS = _score_cand(colC, novC[:, None, None], dltC[:, None, None], m5, okC[:, None])
        # a duplicate fresh column (i == j chains) would break the
        # distinct-column invariant of the cache: mask it out
        dup = pick_j[None, :] & (j == i)[:, None]  # [n, 3]
        colS = colS.masked_fill(dup[:, None, None, None, :], -inf)
        cols3 = torch.where(dup, -1, R).to(torch.int32)
        tvu, tcu = tv[u], tc[u]
        drop = (tcu == i.view(n, 1, 1, 1, 1)) | (tcu == j.view(n, 1, 1, 1, 1)) | (tcu == c.view(n, 1, 1, 1, 1))
        v_m = torch.cat([tvu.masked_fill(drop, -inf), colS], -1)
        c_m = torch.cat([tcu, cols3.view(n, 1, 1, 1, 3).expand(n, 2, B, P, 3)], -1)
        tvN, tcN = _merge_topk(v_m, c_m, K)
        tvR, tcR = _topk_scan(rowS, K)  # [n, 2, S, 3, K]
        for r in range(3):  # rebuilt rows replace the merge (i == j: identical payloads)
            tvN[ar, :, :, R[:, r]] = tvR[:, :, :, r]
            tcN[ar, :, :, R[:, r]] = tcR[:, :, :, r]
        tv[u] = tvN
        tc[u] = tcN
        cur[u] = c + 1
    cur_io.copy_(cur)
    return E, qm, lat, rec, cur_io


def rung_plain(E, qm, lat, cur, method, spec: _KernelSpec) -> tuple:
    """K2's plain version, the whole rung from its cache-less state: the
    score cache built by :func:`init_cache`, then :func:`greedy_plain`.
    Returns ``(E, qmeta, lat, op records, cur)``; ``E, qm, lat, cur`` are
    updated in place."""
    tv, tc = init_cache(E, qm, lat, method, spec.topk)
    return greedy_plain(E, qm, lat, tv, tc, cur, method, spec)


def rung_inputs(E0, qmeta0, lat0, cur0, method, spec: _KernelSpec, device=None) -> tuple:
    """A rung's inputs on ``device``: ``(E, qm, lat, cur, method)``. They are
    new tensors (the rung updates its state in place), never views of the
    arguments; the score cache is the rung's own (K2 builds it on the card,
    :func:`rung_plain` on the CPU).

    Inputs (numpy arrays or tensors): ``E0`` int8 [N, P, O, B], ``qmeta0``
    f32 [N, P, 3] (lo, hi, step), ``lat0`` f32 [N, P], ``cur0`` int32 [N]
    (the next free slot; ``P`` for a padding lane), ``method`` int32 [N]
    (``_METHOD_CODES``). Rows beyond a lane's state are zero digits with
    metadata (0, 0, 1) and latency 0.
    """
    dev = resolve_device(device)
    E = torch.as_tensor(E0).to(dev, torch.int8, copy=True).contiguous()
    qm = torch.as_tensor(qmeta0).to(dev, torch.float32, copy=True).contiguous()
    lat = torch.as_tensor(lat0).to(dev, torch.float32, copy=True).contiguous()
    cur = torch.as_tensor(cur0).to(dev, torch.int32, copy=True).contiguous()
    meth = torch.as_tensor(method).to(dev, torch.int32, copy=True).contiguous()
    N = E.shape[0]
    want = {'E0': (E, (N, spec.P, spec.O, spec.B)), 'qmeta0': (qm, (N, spec.P, 3)), 'lat0': (lat, (N, spec.P)),
            'cur0': (cur, (N,)), 'method': (meth, (N,))}  # fmt: skip
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f'cse_rung: {name} has shape {tuple(t.shape)}, the class {spec} needs {shape}')
    return E, qm, lat, cur, meth


def cse_rung(E0, qmeta0, lat0, cur0, method, spec: _KernelSpec, device=None) -> tuple:
    """One rung of the greedy CSE search for a batch of lanes.

    Returns ``(E, qmeta, lat, op records [N, n_iters, 4], cur)`` as tensors
    on ``device``: record ``t`` of a lane is ``(id0, id1, sub, shift)`` of
    the op placed in slot ``cur0 + t``. Resumable: a lane that ends at
    ``cur == P`` re-enters a larger rung with its final state padded.
    The rung runs K2 on a CUDA device, its plain version on the CPU.
    """
    from . import fused_cse

    return fused_cse.greedy_loop(*rung_inputs(E0, qmeta0, lat0, cur0, method, spec, device), spec)


# --------------------------------------------------------------------------
# host side: lanes, the rung ladder, emission
# --------------------------------------------------------------------------


@dataclass
class LanePrefix:
    """Decision prefix of a beam-fork lane (``torch_beam`` /
    ``search.beam``), in *lane slot space*: inputs 0..ni-1, prefix ops
    ni..ni+d-1 (the rung ladder renumbers op ids to its padded device
    slots). ``E`` is the post-prefix digit tensor [ni+d, O, B]; ``rec`` the
    committed (id0, id1, sub, shift) records [d, 4]; ``qmeta``/``lat`` the
    f32 scoring metadata of the op rows (emission re-derives exact f64
    metadata from the records, like any device decision)."""

    rec: NDArray
    E: NDArray
    qmeta: NDArray
    lat: NDArray
    #: dedupe key, hashed once at construction
    key: tuple = None

    def __post_init__(self):
        if self.key is None:
            self.key = (self.rec.tobytes(), self.E.tobytes())


@dataclass
class _Lane:
    kernel: NDArray
    qintervals: list[QInterval]
    latencies: list[float]
    method: str
    #: optional input-slot permutation (random-restart lanes): the search
    #: sees rows in ``perm`` order, which changes greedy tie-breaks; the
    #: emitted solution is mapped back to the original input order
    perm: NDArray | None = None
    #: optional beam decision prefix: the lane resumes the greedy search
    #: from this state instead of the raw CSD (quality='search'/'max')
    prefix: LanePrefix | None = None
    # filled by preparation
    csd: NDArray | None = None
    shift0: NDArray | None = None
    shift1: NDArray | None = None

    def slot(self, i: int) -> int:
        """Original input index held by device slot ``i``."""
        return int(self.perm[i]) if self.perm is not None else i


@lru_cache(maxsize=64)
def _csd_cached(key: bytes, shape: tuple):
    """Memoized CSD decomposition; returned arrays are shared — callers copy
    before mutating."""
    kernel = np.frombuffer(key, dtype=np.float64).reshape(shape)
    return csd_decompose(kernel)


def _prepare_lane(lane: _Lane) -> None:
    kernel = np.ascontiguousarray(lane.kernel if lane.perm is None else lane.kernel[lane.perm])
    csd, shift0, shift1 = _csd_cached(kernel.tobytes(), kernel.shape)
    csd = csd.copy()
    for i in range(kernel.shape[0]):
        q = lane.qintervals[lane.slot(i)]
        if q.min == 0.0 and q.max == 0.0:
            csd[i] = 0
    lane.csd, lane.shift0, lane.shift1 = csd, shift0, shift1


def _lane_initial_digits(lane: _Lane) -> int:
    return int((lane.csd != 0).sum())


def _lane_rows(lane: _Lane) -> int:
    """Rows carrying state at search entry: the inputs."""
    return lane.csd.shape[0]


def _lane_demand(lane: _Lane) -> int:
    """Slot-demand upper bound: each CSE merge eliminates >= 2 digit pairs,
    so a lane needs at most rows + digits/2 slots."""
    return _lane_rows(lane) + _lane_initial_digits(lane) // 2


def _ladder_P(cur_max: int) -> int:
    """Slot budget of the next rung: the geometric ladder P ≈ 2·cur rounded
    to a power of two (floored at cur + 16)."""
    return next_pow2(cur_max + max(16, cur_max))


def _bucket_lanes(n: int) -> int:
    """Pad the lane axis to a 2^k or 3·2^k bucket."""
    p2 = next_pow2(n)
    t = (p2 // 4) * 3
    return t if n <= t else p2


def _resolve_rung_class(
    P: int, O: int, B: int, adder_size: int, carry_size: int, rows_cap: int, full_rec: bool = False
) -> _KernelSpec:
    """The rung's class: natural P, a cache of 8 per row up to P = 256 and
    16 above, rows trimmed to ``rows_cap`` (the reference's top4 policy);
    ``full_rec`` for a group holding beam-fork lanes."""
    topk = 8 if P <= 256 else 16
    rows_in = min(rows_cap, P)
    return _KernelSpec(P, O, B, adder_size, carry_size, R_in=rows_in if rows_in < P else 0, topk=topk, full_rec=full_rec)


def _rung_bytes_per_lane(spec: _KernelSpec) -> int:
    """Device bytes of one lane in a rung: the shifted digit stack and its
    abs copy, the blocked stage-entry scoring, the score cache, the merge
    transients, the digits, the op records."""
    P, O, B = spec.P, spec.O, spec.B
    blk = min(128, P)
    return (4 * P * O * B * B + 16 * B * blk * P + 16 * B * P * spec.topk + 96 * B * P + P * O * B + 32 * P
            + 16 * spec.n_iters)  # fmt: skip


def _host_state_from(ln: _Lane, rec, E_lane, n_add: int, adder_size: int, carry_size: int, shift0=None) -> DAState:
    """Rebuild the DAState from the device op records.

    Op metadata (qint/latency/cost) is re-derived here in float64 from the
    recorded (id0, id1, sub, shift) decisions — the device's f32 metadata is
    for scoring only. ``shift0`` overrides the lane's (permuted-space) row
    shifts with the caller's unpermuted ones for restart lanes.
    """
    shift0 = ln.shift0 if shift0 is None else shift0
    ni, no, nb = ln.csd.shape
    ops: list[Op] = []
    for i in range(ni):
        sf = 2.0 ** float(shift0[i])
        q = ln.qintervals[i]
        ops.append(Op(i, -1, -1, 0, QInterval(q.min * sf, q.max * sf, q.step * sf), ln.latencies[i], 0.0))
    for t in range(n_add):
        id0, id1, sub, shift = (int(v) for v in rec[t])
        q0, q1 = ops[id0].qint, ops[id1].qint
        dlat, dcost = cost_add(q0, q1, shift, bool(sub), adder_size, carry_size)
        lat = max(ops[id0].latency, ops[id1].latency) + dlat
        ops.append(Op(id0, id1, int(sub), shift, qint_add(q0, q1, shift, False, bool(sub)), lat, dcost))

    expr: list[list[list[int]]] = [[[] for _ in range(no)] for _ in range(ni + n_add)]
    for p, o, b in zip(*np.nonzero(E_lane)):
        expr[p][o].append(encode_digit(int(b), int(E_lane[p, o, b])))
    return DAState(
        shift0=shift0,
        shift1=ln.shift1,
        expr=expr,
        n_bits=nb,
        ops=ops,
        freq_stat={},
        kernel=np.asarray(ln.kernel, dtype=np.float64),
        n_out=no,
    )


def _as_comb(sol) -> CombLogic:
    """Materialize a solution handle (native ``RawComb`` or ``CombLogic``)."""
    return sol if isinstance(sol, CombLogic) else sol.to_comb()


def _lane_key(ln: _Lane) -> tuple:
    """Identity of a lane's search: forks of one lane differ only in their
    decision prefix."""
    return (
        ln.kernel.tobytes(),
        ln.kernel.shape,
        ln.method,
        tuple(ln.qintervals),
        tuple(ln.latencies),
        None if ln.perm is None else ln.perm.tobytes(),
        None if ln.prefix is None else ln.prefix.key,
    )


def _host_lane(ln: _Lane, adder_size: int, carry_size: int, memo: dict) -> CombLogic:
    """Host solve of a lane the device does not take (restart lanes of one
    instance collapse to one solve: the host ignores the permutation)."""
    search_stats['pmax_host_fallbacks'] += 1
    key = (ln.kernel.tobytes(), ln.kernel.shape, ln.method)
    if key not in memo:
        memo[key] = solve_single(ln.kernel, ln.method, ln.qintervals, ln.latencies, adder_size, carry_size)
    return memo[key]


def solve_single_lanes(lanes: list[_Lane], adder_size: int, carry_size: int, device=None) -> list:
    """Solve a batch of independent CMVM instances on the device, emit on host.

    - identical lanes solve once and share the result;
    - lanes whose slot demand exceeds ``PMAX`` solve on the host;
    - the rest group by canonical (O, B) class and run the rung ladder: each
      rung uploads the pending lanes' state padded to ``P`` slots, runs
      :func:`cse_rung`, and fetches digits and records; lanes that reached
      ``cur == P`` resume at the next, larger rung;
    - a rung's lanes run in chunks that fit ``DEVICE_BUDGET``;
    - each group's finished lanes are emitted together (:func:`_emit_group`):
      with the native library, as ``RawComb`` handles (:func:`_as_comb`
      materializes either kind).
    """
    dev = resolve_device(device)
    with telemetry.span('cmvm.jax.csd', n_lanes=len(lanes)):
        for lane in lanes:
            if lane.csd is None:
                _prepare_lane(lane)

    results: dict = {}  # CombLogic, or RawComb from native emission
    dup_of: dict[int, int] = {}
    uniq: dict[tuple, int] = {}
    for k, ln in enumerate(lanes):
        key = _lane_key(ln)
        if key in uniq:
            dup_of[k] = uniq[key]
        else:
            uniq[key] = k
    if dup_of:
        telemetry.counter('sched.dedup_lanes').inc(len(dup_of))

    memo: dict[tuple, CombLogic] = {}
    for k, ln in enumerate(lanes):
        if k in dup_of:
            continue
        if ln.method == 'dummy':
            csd, shift0 = ln.csd, ln.shift0
            if ln.perm is not None:  # renumber back to input order
                csd, shift0 = np.empty_like(csd), np.empty_like(shift0)
                csd[ln.perm], shift0[ln.perm] = ln.csd, ln.shift0
            state = _host_state_from(ln, np.zeros((0, 4), np.int32), csd, 0, adder_size, carry_size, shift0=shift0)
            results[k] = to_solution(state, adder_size, carry_size)
        elif _lane_demand(ln) > PMAX:
            results[k] = _host_lane(ln, adder_size, carry_size, memo)

    active = [k for k in range(len(lanes)) if k not in results and k not in dup_of]
    groups: dict[tuple[int, int], list[int]] = {}
    for k in active:
        gk = (canon_dim(lanes[k].csd.shape[1], 8), canon_dim(lanes[k].csd.shape[2], 2))
        groups.setdefault(gk, []).append(k)
    telemetry.counter('sched.bucket_groups').inc(len(groups))
    telemetry.counter('sched.bucket_lanes').inc(len(active))
    for (O, B), g_active in sorted(groups.items(), key=lambda it: (it[0][0] * it[0][1] ** 2, it[0]), reverse=True):
        emit_jobs, net = _run_group(lanes, O, B, g_active, adder_size, carry_size, dev, memo)
        results.update(net)
        results.update(_emit_group(lanes, emit_jobs, adder_size, carry_size))

    for k, src in dup_of.items():
        results[k] = results[src]
    return [results[k] for k in range(len(lanes))]


def _run_group(lanes, O: int, B: int, active: list[int], adder_size: int, carry_size: int, dev, memo: dict):
    """One canonical (O, B) class through the rung ladder: the emission jobs
    ``(lane, E_lane, rec, shift0)`` of its finished lanes, in host op
    numbering and input order, and the lanes the PMAX safety net solved on
    the host."""
    n_in_max = next_pow2(max(lanes[k].csd.shape[0] for k in active))
    # beam-fork prefixes start above n_in_max and switch the group's rung
    # classes to full-capacity records
    has_prefix = any(lanes[k].prefix is not None for k in active)
    n_act = len(active)
    st_cur = np.full((n_act,), n_in_max, dtype=np.int64)
    mcodes = np.array([_METHOD_CODES[lanes[k].method] for k in active], dtype=np.int32)
    recs: list[list[NDArray]] = [[] for _ in range(n_act)]
    st_E: dict[int, NDArray] = {}  # final digit tensors of finished lanes
    hE: list[NDArray] = []
    hq: list[NDArray] = []
    hl: list[NDArray] = []
    for a, k in enumerate(active):
        ln = lanes[k]
        ni, no, nb = ln.csd.shape
        d = len(ln.prefix.rec) if ln.prefix is not None else 0
        E = np.zeros((n_in_max + d, O, B), dtype=np.int8)
        if d:  # post-prefix digits: inputs at their slots, prefix ops at n_in_max..n_in_max+d-1
            E[:ni, :no, :nb] = ln.prefix.E[:ni]
            E[n_in_max : n_in_max + d, :no, :nb] = ln.prefix.E[ni:]
        else:
            E[:ni, :no, :nb] = ln.csd
        q = np.zeros((n_in_max + d, 3), dtype=np.float32)
        q[:, 2] = 1.0  # benign step for unused slots
        lb = np.zeros((n_in_max + d,), dtype=np.float32)
        for i in range(ni):
            sf = 2.0 ** float(ln.shift0[i])
            qi = ln.qintervals[ln.slot(i)]
            lo, hi, stp = qi.min * sf, qi.max * sf, qi.step * sf
            # all-zero rows carry the lsb sentinel shift and/or an inf step;
            # they are never selected — store benign metadata
            if not all(np.isfinite(v) and abs(v) < 3e38 for v in (lo, hi, stp)):
                lo, hi, stp = 0.0, 0.0, 1.0
            q[i] = (lo, hi, stp)
            lb[i] = ln.latencies[ln.slot(i)]
        if d:
            q[n_in_max:], lb[n_in_max:] = ln.prefix.qmeta, ln.prefix.lat
            # the prefix records in device slot space: op ids shift up with
            # the input padding (emission shifts them back)
            rec = ln.prefix.rec.astype(np.int32).copy()
            for c in (0, 1):
                rec[:, c] = np.where(rec[:, c] >= ni, rec[:, c] + (n_in_max - ni), rec[:, c])
            recs[a].append(rec)
            st_cur[a] = n_in_max + d
        hE.append(E)
        hq.append(q)
        hl.append(lb)
    if has_prefix and telemetry.metrics_on():
        telemetry.counter('search.host_seeded_lanes').inc(sum(lanes[k].prefix is not None for k in active))

    net: dict[int, CombLogic] = {}
    pend = list(range(n_act))
    while pend:
        cur_max = int(st_cur[pend].max())
        P = _ladder_P(cur_max)
        if P > PMAX:
            if cur_max < PMAX:
                P = PMAX  # last, clamped rung
            else:  # safety net: finish the stragglers on the host from scratch
                for a in pend:
                    net[active[a]] = _host_lane(lanes[active[a]], adder_size, carry_size, memo)
                break
        telemetry.counter('sched.rungs').inc()
        spec = _resolve_rung_class(P, O, B, adder_size, carry_size, next_pow2(cur_max), full_rec=has_prefix)
        per_lane = _rung_bytes_per_lane(spec)
        max_lanes = max(1, DEVICE_BUDGET // per_lane)
        if _bucket_lanes(max_lanes) * per_lane > DEVICE_BUDGET:
            max_lanes = 1 << (max_lanes.bit_length() - 1)
            while max_lanes > 1 and _bucket_lanes(max_lanes) * per_lane > DEVICE_BUDGET:
                max_lanes //= 2
        if len(pend) > max_lanes:  # homogeneous chunks: order by remaining demand
            pend = sorted(pend, key=lambda a: -_lane_demand(lanes[active[a]]))

        next_pend: list[int] = []
        for lo in range(0, len(pend), max_lanes):
            chunk = pend[lo : lo + max_lanes]
            bucket = _bucket_lanes(len(chunk))
            cE = np.zeros((bucket, P, O, B), np.int8)
            cq = np.zeros((bucket, P, 3), np.float32)
            cq[:, :, 2] = 1.0
            cl = np.zeros((bucket, P), np.float32)
            cc = np.full((bucket,), P, np.int32)  # padding lanes enter frozen
            cm = np.zeros((bucket,), np.int32)
            for x, a in enumerate(chunk):
                rows = min(hE[a].shape[0], P)
                cE[x, :rows], cq[x, :rows], cl[x, :rows] = hE[a][:rows], hq[a][:rows], hl[a][:rows]
                cc[x], cm[x] = st_cur[a], mcodes[a]
            timed = telemetry.metrics_on()
            t0 = time.perf_counter() if timed else 0.0
            # the rung's K2 launch and the fetch that waits for it
            with _prof.annotate('cmvm.rung'):
                oE, oq, ol, o_rec, ocur = cse_rung(cE, cq, cl, cc, cm, spec, dev)
                cur_f = ocur.cpu().numpy().astype(np.int64)
                op_rec = o_rec.cpu().numpy()
                E_all = oE.cpu().numpy()
                resume = bool((cur_f[: len(chunk)] >= P).any())
                q_all = oq.cpu().numpy() if resume else None
                l_all = ol.cpu().numpy() if resume else None
            if timed:
                # the rung call's device wall clock (dispatch to fetch), the
                # bytes it uploaded, kept on the device and fetched, and the
                # substitutions it committed
                telemetry.counter('cse.device_rounds').inc()
                telemetry.histogram('sched.device_s').observe(time.perf_counter() - t0)
                up = sum(int(t.nbytes) for t in (cE, cq, cl, cc, cm))
                held = sum(int(t.numel() * t.element_size()) for t in (oE, oq, ol, o_rec, ocur))
                telemetry.histogram('sched.hbm_bytes', telemetry.BYTES_BUCKETS).observe(up + held)
                telemetry.counter('sched.upload_bytes').inc(up)
                fetched = cur_f.nbytes + op_rec.nbytes + E_all.nbytes + (q_all.nbytes + l_all.nbytes if resume else 0)
                telemetry.counter('sched.fetch_bytes').inc(int(fetched))
                telemetry.counter('cse.substitutions').inc(int(np.maximum(cur_f[: len(chunk)] - st_cur[chunk], 0).sum()))
            for x, a in enumerate(chunk):
                c0, c1 = int(st_cur[a]), int(cur_f[x])
                if c1 > c0:
                    recs[a].append(op_rec[x, : c1 - c0].copy())
                st_cur[a] = c1
                if c1 >= P:  # budget exhausted: resume at a larger P
                    next_pend.append(a)
                    hE[a], hq[a], hl[a] = E_all[x].copy(), q_all[x].copy(), l_all[x].copy()
                else:
                    st_E[a] = E_all[x].copy()
        pend = next_pend

    emit_jobs: list[tuple[int, NDArray, NDArray, NDArray]] = []
    for a, k in enumerate(active):
        if k in net:
            continue
        ln = lanes[k]
        ni, no, nb = ln.csd.shape
        n_add = int(st_cur[a]) - n_in_max
        rec = np.concatenate(recs[a], axis=0) if recs[a] else np.zeros((0, 4), np.int32)
        E_f = st_E[a]
        # device slots: [0, n_in_max) inputs, [n_in_max, ...) new ops;
        # renumber to host op indices (this lane's inputs first)
        E_lane = np.concatenate([E_f[:ni, :no, :nb], E_f[n_in_max : n_in_max + n_add, :no, :nb]], axis=0)
        shift_down = n_in_max - ni
        if shift_down:
            rec = rec.copy()
            for c in (0, 1):
                rec[:, c] = np.where(rec[:, c] >= ni, rec[:, c] - shift_down, rec[:, c])
        shift0 = ln.shift0
        if ln.perm is not None:
            # restart lane: device slot k held input perm[k]; renumber back
            perm = np.asarray(ln.perm)
            E_un = E_lane.copy()
            E_un[perm] = E_lane[:ni]
            E_lane = E_un
            shift0 = np.empty_like(ln.shift0)
            shift0[perm] = ln.shift0
            rec = rec.copy()
            for c in (0, 1):
                v = rec[:, c]
                rec[:, c] = np.where(v < ni, perm[np.minimum(v, ni - 1)], v)
        emit_jobs.append((k, E_lane, rec, shift0))
    return emit_jobs, net


def _emit_group(lanes, emit_jobs: list, adder_size: int, carry_size: int) -> dict:
    """Adder-tree emission of one group's finished lanes: one native
    ``emit_batch`` call (``RawComb`` handles), or per lane
    ``_host_state_from`` + ``to_solution`` without the native library."""
    with telemetry.span('cmvm.jax.emit', n_jobs=len(emit_jobs)):
        out: dict = {}
        if native.has_emit():
            lane_tuples = []
            for k, E_lane, rec, shift0 in emit_jobs:
                ln = lanes[k]
                qints = np.asarray([(q.min, q.max, q.step) for q in ln.qintervals], np.float64).reshape(-1, 3)
                lane_tuples.append((shift0, ln.shift1, qints, np.asarray(ln.latencies, np.float64), E_lane, rec))
            for (k, _, _, _), sol in zip(emit_jobs, native.emit_batch(lane_tuples, adder_size, carry_size)):
                out[k] = sol
            return out
        for k, E_lane, rec, shift0 in emit_jobs:
            state = _host_state_from(lanes[k], rec, E_lane, len(rec), adder_size, carry_size, shift0=shift0)
            out[k] = to_solution(state, adder_size, carry_size)
        return out


# --------------------------------------------------------------------------
# public API: full two-stage solve with the dc sweep on the device
# --------------------------------------------------------------------------


def _resolve_methods(method0: str, method1: str, hard_dc: int) -> tuple[str, str]:
    if method1 == 'auto':
        method1 = method0 if (hard_dc >= 6 or method0.endswith('dc')) else method0 + '-dc'
    if hard_dc == 0 and not method0.endswith('dc'):
        method0 = method0 + '-dc'
    return method0, method1


def _lane_method(method: str, dc: int, hard_dc_eff: int) -> str:
    """The host forces wmc-dc for dc < 0 candidates under a latency budget
    (api.py _solve / api.cc:84-93); mirror that per lane."""
    if dc < 0 and hard_dc_eff >= 0 and method != 'dummy':
        return 'wmc-dc'
    return method


def solve_torch(
    kernel: NDArray,
    method0: str = 'wmc',
    method1: str = 'auto',
    hard_dc: int = -1,
    decompose_dc: int = -2,
    qintervals: list[QInterval] | None = None,
    latencies: list[float] | None = None,
    adder_size: int = -1,
    carry_size: int = -1,
    search_all_decompose_dc: bool = True,
    method0_candidates: list[str] | None = None,
    n_restarts: int = 1,
    mesh=None,
    quality=None,
    *,
    device=None,
) -> Pipeline:
    """Drop-in ``solve`` with the candidate search on the device (the card
    when ``device`` is None; ``device='cpu'`` runs the plain torch loop)."""
    return solve_torch_many(
        [kernel],
        method0=method0,
        method1=method1,
        hard_dc=hard_dc,
        decompose_dc=decompose_dc,
        qintervals_list=[qintervals] if qintervals else None,
        latencies_list=[latencies] if latencies else None,
        adder_size=adder_size,
        carry_size=carry_size,
        search_all_decompose_dc=search_all_decompose_dc,
        method0_candidates=method0_candidates,
        n_restarts=n_restarts,
        mesh=mesh,
        quality=quality,
        device=device,
    )[0]


def _solve_many_span(fn):
    """Run a batched solve inside the reference's ``cmvm.jax.solve_many`` span."""

    @wraps(fn)
    def wrapped(kernels, *args, **kwargs):
        with telemetry.span('cmvm.jax.solve_many', n_matrices=len(kernels)):
            return fn(kernels, *args, **kwargs)

    return wrapped


@_solve_many_span
def solve_torch_many(
    kernels: list[NDArray],
    method0: str = 'wmc',
    method1: str = 'auto',
    hard_dc: int = -1,
    decompose_dc: int = -2,
    qintervals_list: list[list[QInterval] | None] | None = None,
    latencies_list: list[list[float] | None] | None = None,
    adder_size: int = -1,
    carry_size: int = -1,
    search_all_decompose_dc: bool = True,
    mesh=None,
    method0_candidates: list[str] | None = None,
    n_restarts: int = 1,
    include_host: bool = False,
    quality=None,
    *,
    device=None,
) -> list[Pipeline]:
    """Batched CMVM solve: all (matrix × dc candidate) stage-0 searches run
    as one device batch, then all stage-1 searches; the argmin over
    candidates per matrix is taken on the host.

    - ``method0_candidates``: each (matrix, dc) candidate is searched once
      per selection heuristic; the argmin keeps the cheapest.
    - ``n_restarts``: each stage-0 search also runs under r - 1 seeded
      input-slot permutations (exact after renumbering; only cost differs).
    - ``include_host``: fold the host solver's solution (``backend='auto'``:
      the native solver when it builds) into each matrix's argmin.
    - ``hard_dc >= 0``: the host's shrink-and-retry dc ladder runs as extra
      lanes; if no candidate meets the budget the forced dc = -1 / wmc-dc
      lane is accepted, as the host's terminal break.
    - ``quality`` (a preset name, ``SearchSpec`` or its dict form): the
      spec's portfolio merges into ``method0_candidates``, its restarts
      raise ``n_restarts`` (never lower it), its ``include_host`` is or-ed
      in, and the beam forks stage-0 lanes on the device (``torch_beam``):
      with ``focus == 0`` every eligible lane forks into the base batch;
      with ``focus > 0`` the base batch solves first and only each matrix's
      ``focus`` cheapest base trajectories fork, in a second pair of
      stage-0/stage-1 batches. Every fork carries its own stage-1 solve; the
      unforked lanes stay in the batch, so the result is never worse than
      ``quality='fast'``, which (like None) is today's path byte for byte.

    The parameters bind positionally as the reference's
    ``_solve_jax_many_impl`` does; ``mesh`` must be None (the multi-device
    search is not ported), and the port's ``device`` is keyword-only.
    """
    if mesh is not None:
        raise NotImplementedError('mesh: the multi-device search is not ported')
    dev = resolve_device(device)

    spec = None
    if quality is not None:
        from .search.spec import resolve_quality

        spec = resolve_quality(quality)
        if spec.is_fast:
            spec = None  # the byte-identical default path
    if spec is not None:
        # the spec's axes merge into (never replace) the caller's
        method0_candidates = list(dict.fromkeys([*(method0_candidates or [method0]), *spec.portfolio]))
        n_restarts = max(int(n_restarts or 1), spec.n_restarts)
        include_host = include_host or spec.include_host
        search_stats['beam_width'] = spec.beam
        telemetry.gauge('search.beam_width').set(spec.beam)

    kernels = [np.asarray(k, dtype=np.float64) for k in kernels]
    n_mat = len(kernels)
    qintervals_list = qintervals_list or [None] * n_mat
    latencies_list = latencies_list or [None] * n_mat

    def _qints(mi: int) -> list[QInterval]:
        return list(qintervals_list[mi] or [QInterval(-128.0, 127.0, 1.0)] * kernels[mi].shape[0])

    def _lats(mi: int) -> list[float]:
        return list(latencies_list[mi] or [0.0] * kernels[mi].shape[0])

    # in sweep mode the host solver resolves methods against the budget 10^9
    # when hard_dc < 0, which turns 'auto' into method0 itself
    hard_eff = 10**9 if (search_all_decompose_dc and hard_dc < 0) else hard_dc
    mpairs = list(dict.fromkeys(_resolve_methods(mc, method1, hard_eff) for mc in (method0_candidates or [method0])))

    n_restarts = max(1, int(n_restarts))
    jobs: list[tuple[int, int, int, int]] = []  # (matrix, dc, method pair, restart)
    for mi, kern in enumerate(kernels):
        log2_n = int(ceil(log2(max(kern.shape[0], 1))))
        if search_all_decompose_dc:
            dcs = list(range(-1, min(hard_dc if hard_dc >= 0 else 10**9, log2_n) + 1))
        else:
            dc = min(hard_dc, log2_n, decompose_dc) if decompose_dc != -2 else min(hard_dc, log2_n)
            # the host's shrink-and-retry, flattened into lanes (descending =
            # host preference: the first fitting dc wins)
            dcs = list(range(dc, -2, -1)) if hard_dc >= 0 else [dc]
        jobs.extend(
            (mi, dc, mp, r)
            for dc in dcs
            for mp in range(len(mpairs))
            for r in range(n_restarts if _lane_method(mpairs[mp][0], dc, hard_eff) != 'dummy' else 1)
        )

    # kernel decomposition of each distinct (matrix, dc): one native batch
    # (OpenMP over them) when the library builds
    uniq_md: dict[tuple[int, int], int] = {}
    for mi, dc, _, _ in jobs:
        uniq_md.setdefault((mi, dc), len(uniq_md))
    with telemetry.span('cmvm.jax.decompose', n_unique=len(uniq_md)):
        if native.has_emit():
            splits = native.decompose_batch([kernels[mi] for mi, _ in uniq_md], [dc for _, dc in uniq_md])
        else:
            splits = [kernel_decompose(kernels[mi], dc) for mi, dc in uniq_md]

    lanes0: list[_Lane] = []
    mats1: list[NDArray] = []
    for mi, dc, mp, r in jobs:
        mat0, mat1 = splits[uniq_md[(mi, dc)]]
        method_0 = _lane_method(mpairs[mp][0], dc, hard_eff)
        perm = None
        if r > 0 and method_0 != 'dummy':  # deterministic per-(matrix, dc, restart) shuffle
            prng = np.random.default_rng(0x5EED ^ (mi * 1000003 + (dc + 2) * 1009 + r))
            perm = prng.permutation(mat0.shape[0])
        lanes0.append(_Lane(mat0, _qints(mi), _lats(mi), method_0, perm=perm))
        mats1.append(mat1)

    def _stage1(refs: list[int], sols0: list) -> list:
        """Stage-1 lanes fed by stage-0 outputs, solved as one batch."""
        lanes1 = [
            _Lane(mats1[ji], list(s0.out_qint), list(s0.out_latency), _lane_method(mpairs[jobs[ji][2]][1], jobs[ji][1], hard_eff))
            for ji, s0 in zip(refs, sols0)
        ]  # fmt: skip
        with telemetry.span('cmvm.jax.stage1', n_lanes=len(lanes1)):
            return solve_single_lanes(lanes1, adder_size, carry_size, device=dev)

    # beam forks: decision prefixes as extra stage-0 lanes. exp_refs maps
    # every stage-0 lane to its job; slot 0 is the unforked lane, slots > 0
    # the forks
    exp_refs = list(range(len(jobs)))
    slot_ids = [0] * len(jobs)
    fork_meta: list = [None] * len(jobs)
    two_phase = spec is not None and spec.forks and spec.focus > 0
    if spec is not None and spec.forks and not two_phase:
        from .torch_beam import _expand_forks

        for slot, (ji, fln, meta) in enumerate(_expand_forks(lanes0, spec, adder_size, carry_size, device=dev), 1):
            lanes0.append(fln)
            exp_refs.append(ji)
            slot_ids.append(slot)
            fork_meta.append(meta)

    # both stages keep native solutions as RawComb handles: only the argmin's
    # winners become CombLogics
    with telemetry.span('cmvm.jax.stage0', n_lanes=len(lanes0)):
        sols0 = solve_single_lanes(lanes0, adder_size, carry_size, device=dev)
    sols1 = _stage1(exp_refs, sols0)

    if two_phase:
        # focused forking: fork only each matrix's spec.focus cheapest base
        # trajectories, then solve the forks as a second pair of batches
        from .torch_beam import _expand_forks

        per_m: dict[int, list[tuple[float, int]]] = {}
        for x, (mi, _, _, _) in enumerate(jobs):
            if lanes0[x].method != 'dummy':
                per_m.setdefault(mi, []).append((float(sols0[x].cost) + float(sols1[x].cost), x))
        focus_idx = sorted(x for mi in sorted(per_m) for _, x in sorted(per_m[mi])[: spec.focus])
        forks = _expand_forks([lanes0[x] for x in focus_idx], spec, adder_size, carry_size, device=dev)
        if forks:
            for slot, (si, _, meta) in enumerate(forks, 1):
                exp_refs.append(focus_idx[si])
                slot_ids.append(slot)
                fork_meta.append(meta)
            with telemetry.span('cmvm.jax.stage0', n_lanes=len(forks)):
                sols0_f = solve_single_lanes([fln for _, fln, _ in forks], adder_size, carry_size, device=dev)
            sols0 = list(sols0) + list(sols0_f)
            sols1 = list(sols1) + list(_stage1(exp_refs[len(jobs) :], sols0_f))
    exp_jobs = [jobs[ji] for ji in exp_refs]

    allowed = [inf] * n_mat
    if hard_dc >= 0:
        for mi, kern in enumerate(kernels):
            allowed[mi] = hard_dc + _host_api.minimal_latency(kern, _qints(mi), _lats(mi), carry_size, adder_size)

    # sweep mode: argmin cost over in-budget candidates; otherwise the host
    # preference — the first fitting dc down the ladder, per method pair,
    # restart and beam slot — then argmin across those; nothing fits: the
    # dc = -1 terminal
    best_cost = [inf] * n_mat
    best: list[tuple | None] = [None] * n_mat
    first_fit: dict[tuple[int, int, int, int], tuple] = {}
    terminal: list[tuple | None] = [None] * n_mat
    for (mi, dc, mp, r), slot, sol0, sol1 in zip(exp_jobs, slot_ids, sols0, sols1):
        pair = (sol0, sol1)
        if dc == -1 and r == 0 and slot == 0 and terminal[mi] is None:
            terminal[mi] = pair
        if max((lt for s in pair for lt in s.out_latency), default=0.0) > allowed[mi]:
            continue
        c = float(sol0.cost) + float(sol1.cost)
        if search_all_decompose_dc:
            if c < best_cost[mi]:
                best_cost[mi], best[mi] = c, pair
        elif (mi, mp, r, slot) not in first_fit:
            first_fit[(mi, mp, r, slot)] = pair
    for (mi, _, _, _), pair in first_fit.items():
        c = float(pair[0].cost) + float(pair[1].cost)
        if c < best_cost[mi]:
            best_cost[mi], best[mi] = c, pair

    results: list[Pipeline] = []
    for mi in range(n_mat):
        pair = best[mi] or terminal[mi]
        if pair is None:  # hard_dc < 0 always selects
            raise RuntimeError(f'no candidate solution for matrix {mi}')
        if best[mi] is None:
            search_stats['over_budget_accepts'] += 1
        results.append(Pipeline(stages=(_as_comb(pair[0]), _as_comb(pair[1]))))

    if spec is not None and spec.forks:
        # training data of the learned ranker: every completed fork
        # trajectory as (features, chosen, final-cost-delta) records
        from .search import trace as _strace

        tdir = _strace.trace_dir()
        if tdir:
            totals = [float(s0.cost) + float(s1.cost) for s0, s1 in zip(sols0, sols1)]
            base_totals = {jt: totals[x] for x, (jt, slot) in enumerate(zip(exp_jobs, slot_ids)) if slot == 0}
            _strace.export_records(tdir, _strace.solve_records(kernels, exp_jobs, slot_ids, fork_meta, totals, base_totals))

    if include_host:
        n_win = n_tie = n_rescue = 0
        for mi in range(n_mat):
            host = _host_api.solve(
                kernels[mi], method0=method0, method1=method1, hard_dc=hard_dc, decompose_dc=decompose_dc,
                qintervals=qintervals_list[mi], latencies=latencies_list[mi], adder_size=adder_size,
                carry_size=carry_size, search_all_decompose_dc=search_all_decompose_dc, backend='auto',
                method0_candidates=method0_candidates,
            )  # fmt: skip
            dcost, hcost = float(results[mi].cost), float(host.cost)
            # device lanes strictly beating the host solver, tying, or rescued by it
            n_win, n_tie, n_rescue = n_win + (dcost < hcost), n_tie + (dcost == hcost), n_rescue + (dcost > hcost)
            if hcost < dcost:
                results[mi] = host
        count_search(strict_wins=n_win, ties=n_tie, host_rescues=n_rescue)
    return results
