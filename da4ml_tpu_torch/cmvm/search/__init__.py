"""Search strategies for the CMVM solver: ``quality=`` presets, the frontier
rankers, the solve-trace export and the ranker's trainer.

Counterpart of ``da4ml_tpu/cmvm/search``. ``spec``, ``ranker``, ``trace``
and ``train`` import numpy at most; ``beam`` (the host beam, the device
beam's parity oracle) is imported by its users.
"""

from .ranker import FEATURE_NAMES, CostRanker, LearnedRanker, get_ranker
from .spec import QUALITY_PRESETS, SearchSpec, quality_key, resolve_quality

__all__ = [
    'SearchSpec',
    'QUALITY_PRESETS',
    'resolve_quality',
    'quality_key',
    'CostRanker',
    'LearnedRanker',
    'get_ranker',
    'FEATURE_NAMES',
]
