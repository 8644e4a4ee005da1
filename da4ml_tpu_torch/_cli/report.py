"""``da4ml-tpu-torch report`` — summarize vendor synthesis results.

Parses Vivado (timing summary / utilization / power), Quartus (sta / fit) and
Vitis HLS (csynth.xml) reports found in project directories, merges them with
the project's ``metadata.json``, derives Fmax / latency(ns), and renders a
table (stdout / json / csv / tsv / md / html).

Counterpart of ``da4ml_tpu/_cli/report.py``: pure host code, the same
parsers and tables.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import re
from pathlib import Path
from typing import Any

# --------------------------------------------------------------- Vivado


def parse_timing_summary_vivado(text: str) -> dict[str, Any]:
    """Parse the 'Design Timing Summary' block of report_timing_summary.

    The block is a two-row table: a header line of column names separated by
    2+ spaces, a dashed underline, then the value row.
    """
    loc = text.find('Design Timing Summary')
    if loc < 0:
        return {}
    lines = [ln for ln in text[loc:].split('\n')[3:10] if ln.strip()]
    if len(lines) < 3 or set(lines[1].strip()) != {'-'} and set(lines[1]) != {' ', '-'}:
        return {}
    keys = [k.strip() for k in re.split(r'\s{2,}', lines[0].strip()) if k]
    vals_s = [v for v in re.split(r'\s{2,}', lines[2].strip()) if v]
    out: dict[str, Any] = {}
    for k, v in zip(keys, vals_s):
        try:
            out[k] = int(v) if re.fullmatch(r'-?\d+', v) else float(v)
        except ValueError:
            out[k] = v
    return out


_VIVADO_UTIL_ROWS = [
    'DSPs',
    'LUT as Logic',
    'LUT as Memory',
    'CLB Registers',
    'CARRY8',
    'Register as Latch',
    'Register as Flip Flop',
    'RAMB18',
    'URAM',
    'Block RAM Tile',
]


def parse_utilization_vivado(text: str) -> dict[str, Any]:
    """Parse report_utilization table rows: | name | used | fixed | prohibited | available | % |."""
    out: dict[str, Any] = {}
    for name in _VIVADO_UTIL_ROWS:
        m = re.search(
            rf'\|\s*{re.escape(name)}\s*\|\s*(\d+)\s*\|\s*(\d+)\s*\|\s*(\d+)\s*\|\s*(\d+)\s*\|',
            text,
        )
        if not m:
            continue
        used, fixed, prohibited, available = map(int, m.groups())
        out[name] = used
        out[f'{name}_available'] = available
    if 'Register as Flip Flop' in out:
        out['FF'] = out['Register as Flip Flop'] + out.get('Register as Latch', 0)
        out['FF_available'] = out['Register as Flip Flop_available']
    if 'LUT as Logic' in out:
        out['LUT'] = out['LUT as Logic'] + out.get('LUT as Memory', 0)
        out['LUT_available'] = out['LUT as Logic_available']
    if 'DSPs' in out:
        out['DSP'] = out['DSPs']
    return out


def parse_power_vivado(text: str) -> dict[str, Any]:
    out: dict[str, Any] = {}
    for name in ('Total On-Chip Power (W)', 'Dynamic (W)', 'Device Static (W)'):
        m = re.search(rf'\|\s*{re.escape(name)}\s*\|\s*([^\|]+?)\s*\|', text)
        if m:
            out[name] = m.group(1).strip()
    return out


# -------------------------------------------------------------- Quartus


def parse_timing_quartus(text: str) -> dict[str, Any]:
    out: dict[str, Any] = {}
    m = re.search(r';\s*([\d.]+)\s*MHz\s*;\s*([\d.]+)\s*MHz\s*;', text)
    if m:
        out['Fmax(MHz)'] = float(m.group(1))
        out['Restricted Fmax(MHz)'] = float(m.group(2))
    for section, prefix in (('Setup Summary', 'Setup'), ('Hold Summary', 'Hold')):
        loc = text.find(f'; {section}')
        if loc < 0:
            continue
        # First data row in the section window: clock name followed by numeric
        # slack / TNS / failing-endpoint fields (the header row is non-numeric).
        row = re.search(r';\s*[^;+\n]+?\s*;\s*(-?[\d.]+)\s*;\s*(-?[\d.]+)\s*;\s*(\d+)\s*;', text[loc : loc + 4000])
        if row:
            out[f'{prefix} Slack'] = float(row.group(1))
            out[f'{prefix} TNS'] = float(row.group(2))
            out[f'{prefix} Failing Endpoints'] = int(row.group(3))
    return out


def parse_utilization_quartus(text: str) -> dict[str, Any]:
    out: dict[str, Any] = {}

    def _int(s: str) -> int:
        return int(s.replace(',', ''))

    patterns = [
        (r';\s*Logic utilization \(in ALMs\)\s*;\s*([\d,]+)\s*/\s*([\d,]+)', 'ALM', True),
        (r';\s*Total dedicated logic registers\s*;\s*([\d,]+)', 'Registers', False),
        (r';\s*Total block memory bits\s*;\s*([\d,]+)\s*/\s*([\d,]+)', 'Block Memory Bits', True),
        (r';\s*Total RAM Blocks\s*;\s*([\d,]+)\s*/\s*([\d,]+)', 'RAM Blocks', True),
        (r';\s*Total DSP Blocks\s*;\s*([\d,]+)\s*/\s*([\d,]+)', 'DSP', True),
        (r';\s*Combinational ALUT usage for logic\s*;\s*([\d,]+)', 'LUT', False),
        (r';\s*Dedicated logic registers\s*;\s*([\d,]+)', 'FF', False),
    ]
    for pattern, name, has_avail in patterns:
        m = re.search(pattern, text)
        if not m:
            continue
        out[name] = _int(m.group(1))
        if has_avail:
            out[f'{name}_available'] = _int(m.group(2))
    return out


# ---------------------------------------------------------------- Vitis


def parse_vitis_latency(xml_text: str) -> int | None:
    lats = re.findall(r'<(?:Best|Average|Worst)-caseLatency>(\d+)</(?:Best|Average|Worst)-caseLatency>', xml_text)
    if not lats:
        return None
    vals = sorted({int(v) for v in lats})
    return vals[-1]  # worst case if they differ


# ------------------------------------------------------------- assembly


def _first_existing(*paths: Path) -> Path | None:
    for p in paths:
        if p.exists():
            return p
    return None


def load_project(path: str | Path) -> dict[str, Any]:
    """Merge metadata.json with any vendor reports found in a project dir."""
    path = Path(path)
    meta_path = path / 'metadata.json'
    if not meta_path.exists():
        raise FileNotFoundError(f'{meta_path} not found — not a da4ml-tpu project directory')
    d: dict[str, Any] = json.loads(meta_path.read_text())
    lat = d.get('latency_ticks', d.get('latency'))
    if isinstance(lat, list):
        lat = lat[-1]

    name = d.get('name', 'model')
    rdirs = [path, path / 'reports', path / f'build_{name}' / 'reports']

    # Vivado
    f = _first_existing(*(r / n for r in rdirs for n in ('timing_summary.rpt', f'{name}_post_route_timing.rpt')))
    if f is not None:
        timing = parse_timing_summary_vivado(f.read_text())
        d.update(timing)
        if 'WNS(ns)' in timing and 'clock_period' in d:
            d['actual_period'] = d['clock_period'] - timing['WNS(ns)']
            d['Fmax(MHz)'] = 1000.0 / d['actual_period']
            if lat is not None:
                d['latency(ns)'] = lat * d['actual_period']
    f = _first_existing(*(r / n for r in rdirs for n in ('utilization.rpt', f'{name}_post_route_util.rpt')))
    if f is not None:
        d.update(parse_utilization_vivado(f.read_text()))
    f = _first_existing(*(r / n for r in rdirs for n in ('power.rpt', f'{name}_post_route_power.rpt')))
    if f is not None:
        d.update(parse_power_vivado(f.read_text()))

    # Quartus
    f = _first_existing(*(r / f'{name}.sta.rpt' for r in rdirs))
    if f is not None:
        timing = parse_timing_quartus(f.read_text())
        d.update(timing)
        if 'Fmax(MHz)' in timing:
            d['actual_period'] = 1000.0 / timing['Fmax(MHz)']
            if lat is not None:
                d['latency(ns)'] = lat * d['actual_period']
    f = _first_existing(*(r / f'{name}.fit.rpt' for r in rdirs))
    if f is not None:
        d.update(parse_utilization_quartus(f.read_text()))

    # Vitis
    f = _first_existing(*(r / 'csynth.xml' for r in rdirs), path / 'syn' / 'report' / 'csynth.xml')
    if f is not None:
        v = parse_vitis_latency(f.read_text())
        if v is not None:
            d['latency'] = v

    return d


def extra_info_from_fname(fname: str) -> dict[str, Any]:
    """Extract k=v pairs from '-'-separated directory names."""
    out: dict[str, Any] = {}
    for part in fname.split('-'):
        if '=' not in part:
            continue
        k, v = part.split('=', 1)
        for cast in (int, float, str):
            try:
                out[k] = cast(v)
                break
            except ValueError:
                continue
    return out


# ------------------------------------------------------------- rendering


def _table(vals: list[dict[str, Any]]) -> list[list]:
    attrs: set[str] = set()
    for v in vals:
        attrs.update(v)
    cols = sorted(attrs)
    return [cols] + [[v.get(a, '') for a in cols] for v in vals]


def _fmt_cell(v: Any) -> str:
    if isinstance(v, float):
        return f'{v:.4g}'
    return str(v)


def render_stdout(arr: list[list], full: bool, columns: list[str] | None) -> str:
    default_columns = [
        'name', 'flavor', 'clock_period', 'actual_period', 'cost', 'latency',
        'latency_ticks', 'DSP', 'LUT', 'FF', 'Fmax(MHz)', 'latency(ns)',
    ]  # fmt: skip
    cols = columns if columns is not None else default_columns
    if not full:
        header = arr[0]
        keep = [header.index(c) for c in cols if c in header]
        arr = [[row[i] for i in keep] for row in arr]

    if len(arr) == 2:  # single project: key/value listing
        kw = max((len(str(k)) for k in arr[0]), default=0)
        return '\n'.join(f'{str(k).ljust(kw)} : {_fmt_cell(v)}' for k, v in zip(arr[0], arr[1]))

    widths = [max(len(_fmt_cell(arr[r][c])) for r in range(len(arr))) for c in range(len(arr[0]))]
    try:
        tw = os.get_terminal_size().columns if os.isatty(1) else 1 << 16
    except OSError:
        tw = 1 << 16
    if sum(widths) + 3 * len(widths) + 1 > tw:
        widths = [min(w, max(8, (tw - 3 * len(widths) - 1) // len(widths))) for w in widths]
    lines = [
        '| ' + ' | '.join(_fmt_cell(v).ljust(w)[:w] for v, w in zip(arr[0], widths)) + ' |',
        '|-' + '-|-'.join('-' * w for w in widths) + '-|',
    ]
    for row in arr[1:]:
        lines.append('| ' + ' | '.join(_fmt_cell(v).ljust(w)[:w] for v, w in zip(row, widths)) + ' |')
    return '\n'.join(lines)


def write_output(vals: list[dict[str, Any]], arr: list[list], output: str):
    ext = Path(output).suffix
    with open(output, 'w') as f:
        if ext == '.json':
            json.dump(vals, f, indent=2)
        elif ext in ('.csv', '.tsv'):
            import csv

            writer = csv.writer(f, delimiter=',' if ext == '.csv' else '\t')
            writer.writerows(arr)
        elif ext == '.md':
            f.write('| ' + ' | '.join(map(str, arr[0])) + ' |\n')
            f.write('|' + '|'.join(['---'] * len(arr[0])) + '|\n')
            for row in arr[1:]:
                f.write('| ' + ' | '.join(map(str, row)) + ' |\n')
        elif ext == '.html':
            f.write('<table>\n')
            f.write('  <tr>' + ''.join(f'<th>{a}</th>' for a in arr[0]) + '</tr>\n')
            for row in arr[1:]:
                f.write('  <tr>' + ''.join(f'<td>{a}</td>' for a in row) + '</tr>\n')
            f.write('</table>\n')
        else:
            raise ValueError(f'Unsupported output format: {ext}')


def report_main(args: argparse.Namespace) -> int:
    logger = logging.getLogger('da4ml_tpu_torch.cli.report')
    vals: list[dict[str, Any]] = []
    for p in args.paths:
        try:
            d = load_project(p)
        except Exception as e:
            logger.warning(f'skipping {p}: {e}')
            continue
        for k, v in extra_info_from_fname(Path(p).name).items():
            d.setdefault(k, v)
        vals.append(d)
    if not vals:
        logger.warning('No readable projects.')
        return 1

    key = args.sort_by
    # values for a key may differ in type across projects (e.g. filename tags
    # parsed as int for one dir, left as str for another) — sort numerics
    # first, then everything else by string form, so mixed types never raise
    def _sort_key(d: dict):
        v = d.get(key)
        if v is None:
            return (2, 0.0, '')
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            return (0, float(v), '')
        return (1, 0.0, str(v))

    vals.sort(key=_sort_key)
    arr = _table(vals)

    if args.output == 'stdout':
        print(render_stdout(arr, args.full, args.columns))
    else:
        write_output(vals, arr, args.output)
    return 0


def add_report_args(parser: argparse.ArgumentParser):
    parser.add_argument('paths', type=str, nargs='+', help='Project directories containing metadata.json + vendor reports')
    parser.add_argument('--output', '-o', type=str, default='stdout', help='stdout or a .json/.csv/.tsv/.md/.html file')
    parser.add_argument('--sort-by', '-s', type=str, default='cost', help='Attribute to sort by')
    parser.add_argument('--full', '-f', action='store_true', help='Show all columns on stdout')
    parser.add_argument('--columns', '-c', type=str, nargs='+', default=None, help='Columns to show on stdout')
