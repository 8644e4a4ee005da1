"""``da4ml-tpu-torch convert`` — model file → RTL/HLS project.

Accepts a pickled ``torch.nn.Module`` (``.pt``/``.pth``, traced through the
port's ``trace_model``) or a saved CombLogic/Pipeline ``.json``. Writes the
project, runs a bit-exact DAIS-vs-framework mismatch report
(``mismatches.json``), and can compile and validate the generated emulator
against the DAIS executor (``--validate-rtl``).

The DAIS executor (the validation ``predict``) and the device search
(``--solver-backend torch``) run on ``--device``: the CUDA kernels on the
card by default, their plain torch versions with ``--device cpu``.

Counterpart of ``da4ml_tpu/_cli/convert.py``. Its options with no
counterpart in the port yet are accepted by the parser and refused with
exit code 2, naming the ROADMAP item that brings them.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np

from . import UsageError, add_device_arg, cli_device

#: the reference's options the port does not carry yet: (dest, default,
#: what the option needs, the ROADMAP Queue 1 item)
_UNPORTED = (
    ('deadline', None, '--deadline needs the reliability layer', 10),
    ('fallback', None, '--fallback needs the reliability layer', 10),
    ('resume', None, '--resume needs the reliability layer', 10),
    ('warmup', False, "--warmup needs the device search's warm-up (the reference's `warmup` subcommand)", 12),
    ('warmup_max_dim', 64, "--warmup-max-dim needs the device search's warm-up (the reference's `warmup` subcommand)", 12),
)


def _load_solution(path: Path):
    """Load a saved CombLogic or Pipeline from .json."""
    from ..ir import CombLogic, Pipeline

    blob = json.loads(Path(path).read_text())
    if isinstance(blob, dict) and 'stages' in blob:
        return Pipeline.from_dict(blob)
    return CombLogic.from_dict(blob)


def _emulate(da_model, flavor: str, data: np.ndarray, n_threads: int, verbose: int) -> np.ndarray:
    """Run the generated project by name: the g++ emulation library for HLS;
    for RTL the Verilator/GHDL library when the toolchain exists, else the
    bundled netlist simulator. Never the DAIS executor the result is held to;
    a failed build or load raises."""
    if flavor in ('verilog', 'vhdl') and not da_model.emulation_available():
        print('[WARNING] verilator/ghdl not found; validating with the bundled netlist simulator instead of compiled RTL.')
        return da_model.predict(data, backend='netlist')
    t0 = time.perf_counter()
    da_model.compile()
    if verbose:
        print(f'[INFO] emulator built in {time.perf_counter() - t0:.3f} s')
    return da_model.predict(data, backend='emu', n_threads=n_threads)


def convert(
    model_path: Path,
    outdir: Path,
    n_test_sample: int = 1024,
    clock_period: float = 5.0,
    clock_uncertainty: float = 10.0,
    flavor: str = 'verilog',
    latency_cutoff: float = 5,
    part_name: str = 'xcvu13p-flga2577-2-e',
    verbose: int = 1,
    validate_rtl: bool = False,
    hwconf: tuple[int, int, int] = (1, -1, -1),
    hard_dc: int = 2,
    n_threads: int = 0,
    inputs_kif: tuple[int, int, int] | None = None,
    solver_backend: str = 'auto',
    n_restarts: int = 1,
    method0_candidates: list[str] | None = None,
    quality: str = 'fast',
    device: str | None = None,
):
    """Write the project of ``model_path`` into ``outdir``; returns the
    codegen model. ``device`` is where the DAIS executor and the device
    search run (the card when None). ``quality`` is the CMVM search
    strategy: the beam search on ``'torch'``, a portfolio sweep with a
    warning on the host backends."""
    from ..codegen import HLSModel, RTLModel, VHDLModel

    model_path, outdir = Path(model_path), Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)

    model = None
    if model_path.suffix in {'.pt', '.pth'}:
        import torch

        # a pickled nn.Module (torch.save(model, path)); a bare state_dict
        # carries no architecture and is rejected with a clear message
        model = torch.load(model_path, map_location='cpu', weights_only=False)
        if not isinstance(model, torch.nn.Module):
            raise ValueError(
                f'{model_path} does not contain an nn.Module (got {type(model).__name__}); '
                'save the full module with torch.save(model, path), not just its state_dict'
            )
        model.eval()
        from ..converter import trace_model
        from ..trace import HWConfig, comb_trace

        inp, out = trace_model(
            model,
            HWConfig(*hwconf),
            {
                'hard_dc': hard_dc,
                'backend': solver_backend,
                'n_restarts': n_restarts,
                **({'method0_candidates': method0_candidates} if method0_candidates else {}),
                **({'quality': quality} if quality and quality != 'fast' else {}),
                **({'device': device} if solver_backend == 'torch' else {}),
            },
            verbose > 1,
            inputs_kif=inputs_kif,
        )
        comb = comb_trace(inp, out)
    elif model_path.suffix in {'.h5', '.keras'}:
        raise ValueError(
            f'{model_path.suffix} models need the Keras front end, which da4ml_tpu_torch does not carry '
            '(it imports only torch and numpy); save a torch nn.Module (.pt) or a CombLogic/Pipeline .json'
        )
    elif model_path.suffix == '.json':
        comb = _load_solution(model_path)
    else:
        raise ValueError(f'Unsupported model file format: {model_path.suffix}')

    if flavor == 'verilog':
        da_model = RTLModel(
            comb, 'model', outdir, latency_cutoff=latency_cutoff, part=part_name,
            clock_period=clock_period, clock_uncertainty=clock_uncertainty / 100,
        )  # fmt: skip
    elif flavor == 'vhdl':
        da_model = VHDLModel(
            comb, 'model', outdir, latency_cutoff=latency_cutoff, part=part_name,
            clock_period=clock_period, clock_uncertainty=clock_uncertainty / 100,
        )  # fmt: skip
    elif flavor in ('vitis', 'hls', 'hlslib', 'oneapi'):
        da_model = HLSModel(
            comb, 'model', outdir, latency_cutoff=latency_cutoff, part=part_name, clock_period=clock_period,
            flavor='vitis' if flavor == 'hls' else flavor,
        )  # fmt: skip
    else:
        raise ValueError(f'Unknown flavor: {flavor}')

    da_model.write()
    solution = da_model.solution
    if verbose > 1:
        print(repr(da_model))
    if verbose:
        print(f'[INFO] Project written to {outdir} (flavor={flavor})')

    if not n_test_sample:
        return da_model

    n_in = solution.shape[0] if not hasattr(solution, 'stages') else solution.stages[0].shape[0]
    rng = np.random.default_rng(0)

    def _input_grid_data() -> np.ndarray | None:
        """Random samples on the traced inputs' own fixed-point grid, in
        range — the only data a fixed-point input lane can physically carry
        (off-grid floats would compare the framework's saturation against
        the hardware's wrap)."""
        try:
            k_, i_, f_ = (np.asarray(v, np.float64).ravel() for v in inp.kif)
        except Exception:
            return None
        if not np.all(np.isfinite(i_)) or not np.all(np.isfinite(f_)):
            return None
        eps = 2.0**-f_
        lo_i = np.round(-(2.0**i_) * k_ / eps).astype(np.int64)
        hi_i = np.round((2.0**i_ - eps) / eps).astype(np.int64)
        # stay one lsb inside both ends: the recorded input precision can
        # carry a rounding guard bit (RND input quantizers), and boundary
        # values would round out of range — where the framework saturates
        # but the recorded WRAP input wraps
        return rng.integers(lo_i + 1, np.maximum(hi_i, lo_i + 2), (n_test_sample, len(eps))).astype(np.float64) * eps

    if model is not None:
        import torch

        # input_shape is in torch-native layout
        shape = getattr(model, 'input_shape', None)
        if shape is None:
            raise ValueError('torch models need an `input_shape` attribute (torch-native layout) for validation')
        in_shapes = [tuple(int(d) for d in shape)]

        def _forward(parts):
            with torch.no_grad():
                y = model(torch.as_tensor(parts[0], dtype=torch.float32))
            ys = y if isinstance(y, (list, tuple)) else [y]
            return np.concatenate([np.asarray(v, np.float64).reshape(n_test_sample, -1) for v in ys], axis=1)

        grid = _input_grid_data()
        if grid is not None:
            sizes = [int(np.prod(s)) for s in in_shapes]
            split = np.split(grid, np.cumsum(sizes)[:-1], axis=1)
            data_in = [part.reshape(n_test_sample, *s).astype(np.float32) for part, s in zip(split, in_shapes)]
        else:
            data_in = [rng.uniform(-32, 32, (n_test_sample, *s)).astype(np.float32) for s in in_shapes]
        y_model = _forward(data_in)
        flat_in = np.concatenate([d.reshape(n_test_sample, -1) for d in data_in], axis=1)
        y_comb = solution.predict(flat_in, device=device)

        mask = y_comb != y_model
        ndiff, total = int(np.sum(mask)), int(y_comb.size)
        if ndiff:
            abs_diff = np.abs(y_comb - y_model)[mask]
            rel_diff = abs_diff / (np.abs(y_model[mask]) + 1e-6)
            stats = {
                'max_diff': float(abs_diff.max()),
                'max_rel_diff': float(rel_diff.max()),
                'mean_diff': float(abs_diff.mean()),
                'mean_rel_diff': float(rel_diff.mean()),
            }
            print(f'[WARNING] {ndiff}/{total} mismatches vs framework output: {stats}')
        else:
            stats = {'max_diff': 0.0, 'max_rel_diff': 0.0, 'mean_diff': 0.0, 'mean_rel_diff': 0.0}
            if verbose:
                print(f'[INFO] DAIS simulation matches framework: [0/{total}] mismatches.')
        (outdir / 'mismatches.json').write_text(
            json.dumps({'n_total': total, 'n_mismatch': ndiff, **stats})
        )
    else:
        data_in = rng.uniform(-32, 32, (n_test_sample, n_in)).astype(np.float64)
        flat_in = data_in
        y_comb = solution.predict(flat_in, device=device)

    if validate_rtl:
        y_emu = _emulate(da_model, flavor, flat_in, n_threads, verbose)
        total = int(y_comb.size)
        if not np.array_equal(y_comb, y_emu):
            raise RuntimeError(f'[CRITICAL] emulation validation failed: {int(np.sum(y_comb != y_emu))}/{total} mismatches!')
        if verbose:
            kind = 'RTL' if flavor in ('verilog', 'vhdl') else 'FUNC'
            print(f'[INFO] {kind} validation passed: [0/{total}] mismatches.')

    return da_model


def convert_main(args: argparse.Namespace) -> int:
    for dest, default, what, item in _UNPORTED:
        if getattr(args, dest) != default:
            raise UsageError(f'{what}, which is not ported yet (ROADMAP Queue 1, item {item})')
    device = cli_device(args.device)
    from .. import telemetry

    if args.trace:
        # one sink for the whole conversion; closed (and flushed to disk)
        # before the command returns so the file is complete even when a
        # later step in the same process runs more solves
        telemetry.enable(args.trace)
    try:
        with telemetry.span('cli.convert', model=str(args.model), flavor=args.flavor):
            _convert(args, device)
    finally:
        if args.trace:
            telemetry.disable()
    return 0


def _convert(args: argparse.Namespace, device: str) -> None:
    convert(
        args.model,
        args.outdir,
        n_test_sample=args.n_test_sample,
        clock_period=args.clock_period,
        clock_uncertainty=args.clock_uncertainty,
        flavor=args.flavor,
        latency_cutoff=args.latency_cutoff,
        part_name=args.part_name,
        verbose=args.verbose,
        validate_rtl=args.validate_rtl,
        hwconf=tuple(args.hw_config),
        hard_dc=args.delay_constraint,
        n_threads=args.n_threads,
        inputs_kif=tuple(args.inputs_kif) if args.inputs_kif else None,
        solver_backend=args.solver_backend,
        n_restarts=args.n_restarts,
        method0_candidates=args.methods,
        quality=args.quality,
        device=device,
    )


def add_convert_args(parser: argparse.ArgumentParser):
    parser.add_argument('model', type=Path, help='Model file: a pickled torch nn.Module (.pt/.pth) or a saved CombLogic/Pipeline .json')
    parser.add_argument('outdir', type=Path, help='Output project directory')
    parser.add_argument('--n-test-sample', '-n', type=int, default=1024, help='Validation sample count (0 disables)')
    parser.add_argument('--clock-period', '-c', type=float, default=5.0, help='Clock period in ns')
    parser.add_argument('--clock-uncertainty', '-unc', type=float, default=10.0, help='Clock uncertainty in percent')
    parser.add_argument(
        '--flavor', type=str, default='verilog', choices=['verilog', 'vhdl', 'vitis', 'hls', 'hlslib', 'oneapi']
    )
    parser.add_argument('--latency-cutoff', '-lc', type=float, default=5, help='Latency cutoff for pipelining (<=0: comb)')
    parser.add_argument('--part-name', '-p', type=str, default='xcvu13p-flga2577-2-e', help='FPGA part name')
    parser.add_argument('--verbose', '-v', default=1, type=int, help='0 silent, 1 info, 2 debug')
    parser.add_argument(
        '--validate-rtl', '-vr', action='store_true',
        help='Compile the emulator (g++ for HLS, Verilator/GHDL or the netlist simulator for RTL) and check '
        'bit-exactness against the DAIS executor',
    )  # fmt: skip
    parser.add_argument('--n-threads', '-j', type=int, default=0, help='Threads of the compiled emulator (0 = all)')
    parser.add_argument(
        '--hw-config', '-hc', type=int, nargs=3, metavar=('ADDER_SIZE', 'CARRY_SIZE', 'CUTOFF'), default=[1, -1, -1]
    )
    parser.add_argument('--delay-constraint', '-dc', type=int, default=2, help='hard_dc per CMVM block')
    parser.add_argument('--inputs-kif', '-ikif', type=int, nargs=3, default=None, help='Input precision (keep_neg, int, frac)')
    parser.add_argument(
        '--solver-backend', type=str, default='auto', choices=['auto', 'cpu', 'cpp', 'torch'],
        help="CMVM solver backend: 'auto' (the native solver when it builds, else 'cpu'), 'cpu' (Python), 'cpp' "
        "(native), 'torch' (the device search on --device)",
    )  # fmt: skip
    add_device_arg(parser)
    parser.add_argument(
        '--n-restarts',
        type=int,
        default=1,
        help='Random-restart lanes per CMVM solve (torch backend): widens the sweep, argmin keeps the cheapest',
    )
    parser.add_argument(
        '--methods',
        type=str,
        nargs='+',
        default=None,
        choices=['mc', 'wmc', 'mc-dc', 'mc-pdc', 'wmc-dc', 'wmc-pdc'],
        help='Selection heuristics to sweep (replaces the default wmc; the argmin keeps the cheapest)',
    )
    parser.add_argument(
        '--quality',
        type=str,
        default='fast',
        choices=['fast', 'search', 'max'],
        help="CMVM search strategy: 'fast' (greedy), 'search' (focused beam + host oracle), 'max' (full beam, "
        "every heuristic, restarts); beyond 'fast' the host backends run a portfolio sweep with a warning",
    )
    parser.add_argument('--deadline', type=float, default=None, help='Not ported yet (ROADMAP Queue 1, item 10): exits 2')
    parser.add_argument('--fallback', type=str, default=None, help='Not ported yet (ROADMAP Queue 1, item 10): exits 2')
    parser.add_argument('--resume', type=Path, default=None, help='Not ported yet (ROADMAP Queue 1, item 10): exits 2')
    parser.add_argument(
        '--trace',
        type=Path,
        default=None,
        help='Capture a telemetry trace of the conversion to this path: Chrome trace-event JSON '
        '(open in Perfetto / chrome://tracing), or a streaming JSONL event log when the path '
        'ends in .jsonl. Summarize with `da4ml-tpu-torch stats <path>`. Equivalent to DA4ML_TRACE=<path>.',
    )
    parser.add_argument('--warmup', action='store_true', help='Not ported yet (ROADMAP Queue 1, item 12): exits 2')
    parser.add_argument('--warmup-max-dim', type=int, default=64, help='Not ported yet (ROADMAP Queue 1, item 12): exits 2')
