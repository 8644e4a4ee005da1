"""OpenMetrics/Prometheus text exposition over the metrics registry.

The dotted catalog (:mod:`..catalog`) maps 1:1 onto OpenMetrics families
prefixed ``da4ml_``: counters gain the ``_total`` sample suffix,
seconds-valued names (``*_s``) are renamed ``*_seconds``, and histograms
expose the standard cumulative ``_bucket{le=...}`` / ``_sum`` / ``_count``
triplet. Dimension-carrying names are folded into labels instead of an
unbounded family namespace:

- ``run.mode.<mode>``       -> ``da4ml_run_mode{mode="<mode>"}``

Histogram buckets carry **exemplars** when the registry recorded one
(``Histogram.observe(v, trace_id=...)``): the OpenMetrics
``# {trace_id="..."} <value> <timestamp>`` suffix that links a latency
bucket to the most recent trace that landed in it.

:func:`validate_openmetrics` is a line-by-line grammar checker for the
exposition format (HELP/TYPE ordering, name/label syntax, label-value
escaping, cumulative bucket monotonicity, exemplar syntax and placement,
``# EOF`` terminator) shared by the tests and ``chip_smoke.py``; it
returns the parsed samples so callers can assert on values.

Counterpart of ``da4ml_tpu/telemetry/obs/openmetrics.py``: the same prefix,
folds and text, so one snapshot renders identically in both packages.
"""

from __future__ import annotations

import re

from ..catalog import FOLDS, help_for

#: ``dotted-prefix -> (family, label key)``: trailing name component
#: becomes a label value instead of a per-instance metric family. Families
#: come from the shared catalog (``telemetry.catalog.FOLDS``) so the
#: encoder and the catalog fold identically; only the label key is ours.
_FOLD_LABEL_KEYS = {'run.mode': 'mode'}
_LABEL_FOLD = {prefix: (family, _FOLD_LABEL_KEYS[family]) for prefix, family in FOLDS.items()}

def _family_name(dotted: str) -> str:
    """Dotted catalog name -> OpenMetrics family name (no type suffix)."""
    name = dotted.replace('.', '_').replace('-', '_')
    name = re.sub(r'[^a-zA-Z0-9_]', '_', name)
    if name.endswith('_s') and not name.endswith('_per_s'):
        name = name[:-2] + '_seconds'
    return 'da4ml_' + name


def _fold(dotted: str) -> tuple[str, dict[str, str]]:
    """Split a dotted name into (family dotted name, labels)."""
    for prefix, (family, key) in _LABEL_FOLD.items():
        if dotted.startswith(prefix) and len(dotted) > len(prefix):
            return family, {key: dotted[len(prefix) :]}
    return dotted, {}


def _escape_label(v: str) -> str:
    return v.replace('\\', '\\\\').replace('"', '\\"').replace('\n', '\\n')


def _escape_help(v: str) -> str:
    return v.replace('\\', '\\\\').replace('\n', '\\n')


def _fmt(v: float) -> str:
    if v != v:  # NaN
        return 'NaN'
    if v == float('inf'):
        return '+Inf'
    if v == float('-inf'):
        return '-Inf'
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _labels_str(labels: dict[str, str]) -> str:
    if not labels:
        return ''
    inner = ','.join(f'{k}="{_escape_label(str(v))}"' for k, v in sorted(labels.items()))
    return '{' + inner + '}'


def _exemplar_str(ex) -> str:
    """Render a registry exemplar triple as the OpenMetrics suffix."""
    if not ex:
        return ''
    trace_id, value, ts = ex
    return f' # {{trace_id="{_escape_label(str(trace_id))}"}} {_fmt(float(value))} {_fmt(float(ts))}'


def render_openmetrics(snapshot: dict | None = None) -> str:
    """Render a metrics snapshot (default: the live registry, with health
    gauges refreshed) as OpenMetrics text ending in ``# EOF``."""
    if snapshot is None:
        from ..metrics import metrics_snapshot
        from .health import refresh_computed_gauges

        refresh_computed_gauges()
        snapshot = metrics_snapshot()

    # group dotted metrics into families (label folding can merge several
    # registry entries into one family)
    families: dict[str, dict] = {}
    for dotted, m in sorted(snapshot.items()):
        kind = m.get('type')
        if kind not in ('counter', 'gauge', 'histogram'):
            continue
        fam_dotted, labels = _fold(dotted)
        fam = families.setdefault(fam_dotted, {'type': kind, 'samples': []})
        if fam['type'] != kind:
            # conflicting types across a folded family: keep the first,
            # expose the oddball unfolded rather than emitting bad text
            fam = families.setdefault(dotted, {'type': kind, 'samples': []})
            labels = {}
        fam['samples'].append((labels, m))

    lines: list[str] = []
    for fam_dotted, fam in sorted(families.items()):
        name = _family_name(fam_dotted)
        kind = fam['type']
        help_text = help_for(fam_dotted)  # telemetry.catalog.METRICS
        lines.append(f'# HELP {name} {_escape_help(help_text)}')
        lines.append(f'# TYPE {name} {kind}')
        for labels, m in fam['samples']:
            ls = _labels_str(labels)
            if kind == 'counter':
                lines.append(f'{name}_total{ls} {_fmt(m["value"])}')
            elif kind == 'gauge':
                lines.append(f'{name}{ls} {_fmt(m["value"])}')
            else:  # histogram: registry buckets are per-bin -> cumulate
                bounds = m.get('bounds', [])
                counts = m.get('buckets', [])
                exemplars = m.get('exemplars') or {}
                cum = 0
                for bi, (bound, c) in enumerate(zip(bounds, counts)):
                    cum += c
                    bl = dict(labels, le=_fmt(float(bound)))
                    lines.append(f'{name}_bucket{_labels_str(bl)} {cum}{_exemplar_str(exemplars.get(str(bi)))}')
                total = m.get('count', 0)
                bl = dict(labels, le='+Inf')
                lines.append(f'{name}_bucket{_labels_str(bl)} {total}{_exemplar_str(exemplars.get(str(len(bounds))))}')
                lines.append(f'{name}_sum{ls} {_fmt(float(m.get("sum", 0.0)))}')
                lines.append(f'{name}_count{ls} {total}')
    lines.append('# EOF')
    return '\n'.join(lines) + '\n'


# ---------------------------------------------------------------------------
# grammar validation (tests + chip_smoke.py)
# ---------------------------------------------------------------------------

_NAME_RE = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*$')
_NUM = r'-?(?:\d+(?:\.\d+)?(?:[eE][+-]?\d+)?|\+Inf|-Inf|NaN)'
_SAMPLE_RE = re.compile(
    r'^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)'
    r'(?:\{(?P<labels>[^{}]*)\})?'
    rf' (?P<value>{_NUM})'
    # optional OpenMetrics exemplar: " # {labels} value [timestamp]"
    r'(?: # \{(?P<ex_labels>[^{}]*)\}'
    rf' (?P<ex_value>{_NUM})'
    r'(?: (?P<ex_ts>\d+(?:\.\d+)?(?:[eE][+-]?\d+)?))?)?$'
)
_LABEL_RE = re.compile(r'^(?P<key>[a-zA-Z_][a-zA-Z0-9_]*)="(?P<val>(?:[^"\\]|\\["\\n])*)"$')


def _split_labels(raw: str) -> dict[str, str]:
    """Split a label body on commas that are outside quoted values."""
    labels: dict[str, str] = {}
    if not raw:
        return labels
    parts: list[str] = []
    depth_quote = False
    cur = []
    i = 0
    while i < len(raw):
        ch = raw[i]
        if ch == '\\' and depth_quote and i + 1 < len(raw):
            cur.append(raw[i : i + 2])
            i += 2
            continue
        if ch == '"':
            depth_quote = not depth_quote
        if ch == ',' and not depth_quote:
            parts.append(''.join(cur))
            cur = []
        else:
            cur.append(ch)
        i += 1
    if cur:
        parts.append(''.join(cur))
    for part in parts:
        m = _LABEL_RE.match(part)
        if m is None:
            raise ValueError(f'bad label pair: {part!r}')
        labels[m.group('key')] = m.group('val')
    return labels


def _parse_value(s: str) -> float:
    if s == '+Inf':
        return float('inf')
    if s == '-Inf':
        return float('-inf')
    return float(s)


def validate_openmetrics(text: str) -> dict[str, dict]:
    """Validate OpenMetrics exposition text line by line; raise ``ValueError``
    on any grammar violation. Returns ``{family: {'type', 'help', 'samples':
    {sample_line_name+labels: value}}}`` for value assertions."""
    lines = text.split('\n')
    if lines and lines[-1] == '':
        lines.pop()
    if not lines or lines[-1] != '# EOF':
        raise ValueError('exposition must end with "# EOF"')
    families: dict[str, dict] = {}
    current: str | None = None
    seen_order: list[str] = []
    for i, line in enumerate(lines[:-1]):
        if not line:
            raise ValueError(f'line {i}: empty line inside exposition')
        if line.startswith('# HELP '):
            rest = line[len('# HELP ') :]
            name, _, help_text = rest.partition(' ')
            if not _NAME_RE.match(name):
                raise ValueError(f'line {i}: bad metric name in HELP: {name!r}')
            if name in families:
                raise ValueError(f'line {i}: duplicate HELP for {name}')
            families[name] = {'type': None, 'help': help_text, 'samples': {}}
            seen_order.append(name)
            current = name
            continue
        if line.startswith('# TYPE '):
            rest = line[len('# TYPE ') :]
            name, _, kind = rest.partition(' ')
            if name not in families or families[name]['type'] is not None:
                raise ValueError(f'line {i}: TYPE without preceding HELP (or duplicate) for {name}')
            if name != current:
                raise ValueError(f'line {i}: TYPE {name} interleaved with family {current}')
            if kind not in ('counter', 'gauge', 'histogram', 'summary', 'info', 'unknown'):
                raise ValueError(f'line {i}: unknown TYPE {kind!r}')
            families[name]['type'] = kind
            continue
        if line.startswith('#'):
            raise ValueError(f'line {i}: unexpected comment {line!r}')
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f'line {i}: unparsable sample line {line!r}')
        sname = m.group('name')
        labels = _split_labels(m.group('labels') or '')
        value = _parse_value(m.group('value'))
        if current is None:
            raise ValueError(f'line {i}: sample before any HELP/TYPE block')
        fam = families[current]
        kind = fam['type']
        if kind == 'counter':
            if sname != current + '_total':
                raise ValueError(f'line {i}: counter sample must be {current}_total, got {sname}')
            if value < 0:
                raise ValueError(f'line {i}: counter value negative')
        elif kind == 'gauge':
            if sname != current:
                raise ValueError(f'line {i}: gauge sample must be {current}, got {sname}')
        elif kind == 'histogram':
            if sname not in (current + '_bucket', current + '_sum', current + '_count'):
                raise ValueError(f'line {i}: histogram sample {sname} not in bucket/sum/count')
            if sname.endswith('_bucket') and 'le' not in labels:
                raise ValueError(f'line {i}: histogram bucket without le label')
        else:
            raise ValueError(f'line {i}: sample for family {current} with no TYPE')
        ex_labels_raw = m.group('ex_labels')
        if ex_labels_raw is not None:
            # exemplars are only legal on counter _total and histogram
            # _bucket samples (OpenMetrics 1.0 §exemplars)
            if kind == 'histogram':
                if not sname.endswith('_bucket'):
                    raise ValueError(f'line {i}: exemplar on histogram sample {sname} (only _bucket may carry one)')
            elif kind != 'counter':
                raise ValueError(f'line {i}: exemplar on {kind} sample {sname}')
            try:
                ex_labels = _split_labels(ex_labels_raw)
            except ValueError as e:
                raise ValueError(f'line {i}: bad exemplar labels: {e}') from None
            if sum(len(k) + len(v) for k, v in ex_labels.items()) > 128:
                raise ValueError(f'line {i}: exemplar label set exceeds 128 characters')
            _parse_value(m.group('ex_value'))
        key = sname + _labels_str({k: v for k, v in labels.items()})
        if key in fam['samples']:
            raise ValueError(f'line {i}: duplicate sample {key}')
        fam['samples'][key] = value

    # semantic checks per histogram family: cumulative monotone buckets and
    # the +Inf bucket equal to _count
    for name, fam in families.items():
        if fam['type'] != 'histogram':
            continue
        by_series: dict[str, list[tuple[float, float]]] = {}
        counts: dict[str, float] = {}
        for key, value in fam['samples'].items():
            if key.startswith(name + '_bucket'):
                labels = _split_labels(key[len(name + '_bucket') :].strip('{}'))
                le = labels.pop('le')
                series = _labels_str(labels)
                by_series.setdefault(series, []).append((_parse_value(le), value))
            elif key.startswith(name + '_count'):
                series = key[len(name + '_count') :].strip('{}')
                counts[_labels_str(_split_labels(series))] = value
        for series, buckets in by_series.items():
            buckets.sort(key=lambda t: t[0])
            prev = -1.0
            for le, v in buckets:
                if v < prev:
                    raise ValueError(f'{name}{series}: bucket counts not cumulative at le={le}')
                prev = v
            if buckets[-1][0] != float('inf'):
                raise ValueError(f'{name}{series}: missing le="+Inf" bucket')
            if series in counts and buckets[-1][1] != counts[series]:
                raise ValueError(f'{name}{series}: +Inf bucket != _count')
    return families


#: content type a compliant scraper expects from /metrics
CONTENT_TYPE = 'application/openmetrics-text; version=1.0.0; charset=utf-8'
