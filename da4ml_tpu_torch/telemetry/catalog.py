"""The declarative metric catalog: every family this package emits.

One table, two consumers:

- :mod:`.obs.openmetrics` renders each family's OpenMetrics ``HELP``
  string from the ``METRICS`` value (no second copy of the text);
- ``tests/test_torch_telemetry.py`` AST-scans the package for
  ``counter(...)`` / ``gauge(...)`` / ``histogram(...)`` / ``timer(...)``
  emission sites and fails when an emitted name is missing here or when a
  catalog entry no longer has an emission site.

Counterpart of ``da4ml_tpu/telemetry/catalog.py``. A family keeps the
reference's name and HELP text wherever the port has its counterpart, so a
scrape of either package renders the same text for it: the CUDA DAIS kernel
plays the reference's ``mode='pallas'``, so its build and launch metrics
keep ``run.pallas.*``, and the device search keeps the ``sched.*`` /
``search.*`` / ``cse.*`` names. Families whose modules are not ported yet
are left out (``ROADMAP.md`` names each with its item).

Dynamic families (``run.mode.<mode>``) are catalogued under their *folded*
family name — the exposition layer folds the trailing component into a
label — and their construction sites are registered in ``DYNAMIC_SITES``.

This module is import-light on purpose (stdlib only).
"""

from __future__ import annotations

__all__ = ['DYNAMIC_SITES', 'FOLDS', 'METRICS', 'fold_family', 'help_for']

#: dotted family name -> HELP text (OpenMetrics HELP)
METRICS: dict[str, str] = {
    # -- solve plane --------------------------------------------------------
    'solve.calls': 'cmvm.api.solve invocations',
    'solve.duration_s': 'wall clock per solve',
    'solve.adders': 'result cost (adder count) per solve',
    # -- device search ------------------------------------------------------
    'cse.device_rounds': 'greedy-CSE device calls',
    'cse.substitutions': 'CSE substitutions materialized across lanes',
    'search.beam_width': 'current adaptive beam width',
    'search.lanes_expanded': 'beam lanes expanded on device',
    'search.frontier_culled': 'frontier states culled by dominance',
    'search.device_forks': 'beam forks dispatched to the device path',
    'search.device_prunes': 'beam prunes decided on device',
    'search.fork_lanes': 'lanes created by device forks',
    'search.host_rescues': 'device-search rungs rescued by the host fallback',
    'search.host_seeded_lanes': 'beam lanes seeded from host solutions',
    'search.strict_wins': 'candidate comparisons won strictly',
    'search.ties': 'candidate comparisons tied on cost',
    'search.trace_records': 'search-trace records written (DA4ML_SEARCH_TRACE_DIR)',
    'sched.rungs': 'CMVM search rungs scheduled',
    'sched.bucket_groups': 'same-shape rung groups batched into one dispatch',
    'sched.bucket_lanes': 'lanes packed via shape-bucket batching',
    'sched.dedup_lanes': 'duplicate lanes elided by the scheduler',
    'sched.fetch_bytes': 'bytes fetched from device per rung chunk',
    'sched.upload_bytes': 'bytes uploaded to device per rung chunk',
    'sched.device_s': 'device wall clock per CMVM search rung chunk (dispatch to fetch)',
    'sched.hbm_bytes': 'estimated device-resident bytes per CMVM search rung chunk',
    # -- runtime ------------------------------------------------------------
    'run.mode': 'DAIS executors constructed per resolved execution mode',
    'run.samples': 'DAIS inference samples served',
    'run.samples_per_s': 'recent DAIS inference throughput',
    'run.batch_s': 'wall clock per inference batch',
    'run.batch_samples': 'samples per inference batch',
    'run.compile_s': 'runtime executor compile wall clock',
    'run.pallas.compile_s': 'pallas mega-kernel build + first-compile wall clock',
    'run.pallas.vmem_bytes': 'estimated VMEM footprint per pallas mega-kernel grid step',
    'run.device_s': 'device wall clock per DAIS inference batch',
    'run.hbm_bytes': 'estimated device-resident bytes per DAIS inference batch',
    'runtime.samples': 'samples served by the legacy runtime entry point',
    'runtime.run_s': 'wall clock per legacy runtime batch',
    'trace.ops': 'DAIS ops traced into programs',
    'fuse.stages': 'pipeline stages fused',
    'fuse.seam_ops': 'seam ops eliminated by pipeline fusion',
    'fuse.depth_before': 'pipeline depth before fusion',
    'fuse.depth_after': 'pipeline depth after fusion',
    # -- health -------------------------------------------------------------
    'health.status': 'aggregate health: 0 ok, 1 degraded',
}

#: label-folded family prefixes: a literal ``<prefix><variant>`` emission
#: (e.g. ``run.mode.fused_ir``) belongs to the ``<family>`` catalog entry;
#: the OpenMetrics encoder folds the variant into a label the same way.
FOLDS: dict[str, str] = {
    'run.mode.': 'run.mode',
}


def fold_family(name: str) -> str:
    """The catalog family a metric name belongs to (identity when unfolded)."""
    for prefix, family in FOLDS.items():
        if name.startswith(prefix):
            return family
    return name


#: registered dynamic emission sites: module (repo-relative) -> folded
#: family names its f-string metrics resolve to. The catalog test rejects
#: any non-literal ``counter(f'...')`` call outside this table.
DYNAMIC_SITES: dict[str, tuple[str, ...]] = {
    'da4ml_tpu_torch/runtime/torch_backend.py': ('run.mode',),
    'da4ml_tpu_torch/cmvm/torch_search.py': ('search.lanes_expanded', 'search.fork_lanes', 'search.frontier_culled',
                                             'search.device_forks', 'search.device_prunes', 'search.strict_wins',
                                             'search.ties', 'search.host_rescues'),  # fmt: skip
}


def help_for(family: str) -> str:
    """HELP text for a (folded) family; a generic one when uncatalogued
    (the catalog test keeps this branch unreachable for package metrics)."""
    return METRICS.get(family, f'da4ml_tpu_torch metric {family}')
