"""``da4ml-tpu-torch`` command line interface.

Seven subcommands:

- ``convert`` — model file (a pickled ``torch.nn.Module`` ``.pt``/``.pth``,
  or a saved CombLogic/Pipeline ``.json``) → RTL/HLS project with optional
  bit-exact validation;
- ``report`` — parse vendor synthesis reports from project directories into
  a summary table;
- ``verify`` — run the DAIS static-analysis verifier over saved programs or
  generated project directories; ``--conformance`` adds the cross-backend
  differential pass, ``--fuzz N`` runs the corpus conformance +
  transfer-soundness sweep without paths;
- ``lint-opcodes`` — fail on opcode dispatch sites outside the declarative
  opcode table's allowlisted consumers;
- ``stats`` — summarize a telemetry trace captured with ``--trace`` /
  ``DA4ML_TRACE``; ``--follow`` tails a streaming JSONL trace live;
- ``trace-view`` — merge per-process traces into one clock-aligned
  Perfetto timeline;
- ``monitor`` — serve the live ``/metrics`` / ``/healthz`` / ``/statusz``
  endpoints, optionally mirroring a followed trace.

``convert`` and ``verify`` run on the CUDA device unless ``--device cpu`` is
given; with no CUDA device and no ``--device cpu`` they exit 2 with a
message, and nothing runs on the host in the card's place.

Counterpart of ``da4ml_tpu/_cli/``; its other subcommands wait for the
modules they drive.
"""

from __future__ import annotations

import argparse
import sys


class UsageError(Exception):
    """A request the command refuses before doing any work (exit code 2)."""


def cli_device(name: str) -> str:
    """The torch device a subcommand runs on: ``'cuda'`` (the default)
    needs a CUDA device, and never falls back to the host."""
    if name == 'cuda':
        import torch

        if not torch.cuda.is_available():
            raise UsageError(
                'no CUDA device is available; pass --device cpu to run on the host (the kernels\' plain versions)'
            )
    return name


def add_device_arg(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        '--device',
        choices=['cuda', 'cpu'],
        default='cuda',
        help="where the DAIS executor and the device search run: 'cuda' (the CUDA kernels, the default) or "
        "'cpu' (their plain torch versions)",
    )


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog='da4ml-tpu-torch', description='Distributed-arithmetic compiler on PyTorch/CUDA')
    sub = parser.add_subparsers(dest='command', required=True)

    from ..analysis.driftlint import add_lint_opcodes_args, lint_opcodes_main
    from .convert import add_convert_args, convert_main
    from .report import add_report_args, report_main
    from .verify import add_verify_args, verify_main

    p_convert = sub.add_parser('convert', help='Convert a model into an RTL/HLS project')
    add_convert_args(p_convert)
    p_convert.set_defaults(func=convert_main)

    p_report = sub.add_parser('report', help='Summarize synthesis reports of project directories')
    add_report_args(p_report)
    p_report.set_defaults(func=report_main)

    p_verify = sub.add_parser('verify', help='Statically verify saved DAIS programs (well-formedness, intervals, lint)')
    add_verify_args(p_verify)
    p_verify.set_defaults(func=verify_main)

    p_lint = sub.add_parser(
        'lint-opcodes', help='Fail on opcode dispatch sites outside the declarative table consumers'
    )
    add_lint_opcodes_args(p_lint)
    p_lint.set_defaults(func=lint_opcodes_main)

    from .stats import add_stats_args, stats_main

    p_stats = sub.add_parser('stats', help='Summarize a telemetry trace captured with --trace / DA4ML_TRACE')
    add_stats_args(p_stats)
    p_stats.set_defaults(func=stats_main)

    from .trace_view import add_trace_view_args, trace_view_main

    p_tv = sub.add_parser('trace-view', help='Merge per-process JSONL traces into one Perfetto fleet timeline')
    add_trace_view_args(p_tv)
    p_tv.set_defaults(func=trace_view_main)

    from .monitor import add_monitor_args, monitor_main

    p_mon = sub.add_parser('monitor', help='Serve the live /metrics /healthz /statusz observability endpoints')
    add_monitor_args(p_mon)
    p_mon.set_defaults(func=monitor_main)

    args = parser.parse_args(argv)
    try:
        return args.func(args) or 0
    except UsageError as e:
        print(f'da4ml-tpu-torch {args.command}: {e}', file=sys.stderr)
        return 2


if __name__ == '__main__':
    sys.exit(main())
