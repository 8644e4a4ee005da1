"""SearchSpec: the declarative description of one CMVM search strategy.

``cmvm.api.solve(quality=...)`` accepts a preset name (``'fast'``,
``'search'``, ``'max'``), a :class:`SearchSpec`, or its ``to_dict`` form.
``'fast'`` is the default and is byte-identical to the pre-beam solver; the
other presets widen the device sweep with a beam over (decompose-dc
candidate x heuristic portfolio x restart seed x beam slot).

Counterpart of ``da4ml_tpu/cmvm/search/spec.py``. This module imports
neither numpy nor torch: the host solver and the command line resolve
quality knobs without touching the device stack.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

#: every selection heuristic the beam portfolio may name (heuristics.py)
_KNOWN_METHODS = ('mc', 'wmc', 'mc-dc', 'mc-pdc', 'wmc-dc', 'wmc-pdc')


@dataclass(frozen=True)
class SearchSpec:
    """One search strategy, fully determined (hashable, checkpoint-keyable).

    beam
        Frontier width of the decision-prefix beam per (matrix, dc, method,
        restart) lane; 1 disables forking.
    depth
        Greedy decisions explored by the fork phase before the surviving
        prefixes hand off to the rung ladder; 0 disables forking.
    portfolio
        Extra stage-0 selection heuristics swept as additional device lanes
        (merged with the caller's ``method0``/``method0_candidates``).
    n_restarts
        Random input-permutation restart lanes (the solve's ``n_restarts``
        is raised to this; never lowered).
    include_host
        Fold the host reference solution into the per-matrix argmin — the
        never-worse-than-oracle guarantee, at the price of one host solve
        per matrix.
    ranker
        Frontier pruning model: ``'cost'`` (exact DAIS adder cost,
        cmvm/cost.py — the default) or a path to a trained ranker JSON
        (search/ranker.py ``LearnedRanker``).
    focus
        0 forks every eligible (matrix, dc, method, restart) lane in one
        device batch; k > 0 solves the base batch first and forks only each
        matrix's k cheapest base trajectories in a second batch — the
        sublinear-wall mode: beam slots go where the base sweep says they
        matter, so the device pays ~(base + k*beam) lanes instead of
        ~(base * beam).
    """

    beam: int = 1
    depth: int = 0
    portfolio: tuple[str, ...] = ()
    n_restarts: int = 1
    include_host: bool = False
    ranker: str = 'cost'
    focus: int = 0

    def __post_init__(self):
        if int(self.beam) < 1:
            raise ValueError(f'beam must be >= 1, got {self.beam}')
        if int(self.depth) < 0:
            raise ValueError(f'depth must be >= 0, got {self.depth}')
        if int(self.focus) < 0:
            raise ValueError(f'focus must be >= 0, got {self.focus}')
        if int(self.n_restarts) < 1:
            raise ValueError(f'n_restarts must be >= 1, got {self.n_restarts}')
        object.__setattr__(self, 'portfolio', tuple(self.portfolio))
        for m in self.portfolio:
            if m not in _KNOWN_METHODS:
                raise ValueError(f'unknown portfolio method {m!r} (expected one of {_KNOWN_METHODS})')
        if not isinstance(self.ranker, str) or not self.ranker:
            raise ValueError(f'ranker must be a non-empty string, got {self.ranker!r}')

    @property
    def is_fast(self) -> bool:
        """True when this spec is exactly the pre-beam greedy path."""
        return (
            self.beam <= 1
            and self.depth <= 0
            and not self.portfolio
            and self.n_restarts <= 1
            and not self.include_host
        )

    @property
    def forks(self) -> bool:
        """True when the spec actually runs the decision-prefix beam."""
        return self.beam > 1 and self.depth > 0

    def to_dict(self) -> dict:
        return {
            'beam': int(self.beam),
            'depth': int(self.depth),
            'portfolio': list(self.portfolio),
            'n_restarts': int(self.n_restarts),
            'include_host': bool(self.include_host),
            'ranker': self.ranker,
            'focus': int(self.focus),
        }

    @classmethod
    def from_dict(cls, d: dict) -> 'SearchSpec':
        known = {'beam', 'depth', 'portfolio', 'n_restarts', 'include_host', 'ranker', 'focus'}
        extra = set(d) - known
        if extra:
            raise ValueError(f'unknown SearchSpec keys {sorted(extra)}')
        kw = dict(d)
        if 'portfolio' in kw:
            kw['portfolio'] = tuple(kw['portfolio'])
        return cls(**kw)

    def with_ranker(self, ranker: str) -> 'SearchSpec':
        return replace(self, ranker=ranker)


#: the quality= presets; 'fast' is the byte-identical default path.
#: 'search' is the bounded-wall mode: focused two-phase forking (only each
#: matrix's ``focus`` cheapest base trajectories fork); 'max' forks every
#: axis everywhere and is for hardware with real idle capacity.
QUALITY_PRESETS: dict[str, SearchSpec] = {
    'fast': SearchSpec(),
    'search': SearchSpec(beam=5, depth=1, focus=3, include_host=True),
    'max': SearchSpec(beam=8, depth=2, portfolio=_KNOWN_METHODS, n_restarts=4, include_host=True),
}


def resolve_quality(quality) -> SearchSpec:
    """Normalize a ``quality=`` argument to a :class:`SearchSpec`.

    Accepts None / a preset name / a SearchSpec / a ``to_dict`` mapping.
    """
    if quality is None:
        return QUALITY_PRESETS['fast']
    if isinstance(quality, SearchSpec):
        return quality
    if isinstance(quality, dict):
        return SearchSpec.from_dict(quality)
    if isinstance(quality, str):
        try:
            return QUALITY_PRESETS[quality]
        except KeyError:
            raise ValueError(f'unknown quality preset {quality!r} (expected one of {sorted(QUALITY_PRESETS)})') from None
    raise TypeError(f'quality must be a preset name, SearchSpec, or dict; got {type(quality).__name__}')


def quality_key(quality) -> 'dict | None':
    """Canonical checkpoint-key form of a quality argument: ``None`` for the
    byte-identical fast path (so pre-existing checkpoint keys are
    untouched), else the spec's ``to_dict``. Round-trips: two arguments that
    resolve to the same spec produce the same key."""
    if quality in (None, 'fast'):
        return None
    spec = resolve_quality(quality)
    return None if spec.is_fast else spec.to_dict()
