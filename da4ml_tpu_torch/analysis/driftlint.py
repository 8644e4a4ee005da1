"""Opcode-dispatch drift lint (``da4ml-tpu-torch lint-opcodes``).

The declarative opcode table (``ir/optable.py``) is the single source of
truth for DAIS semantics. The one way that guarantee erodes is a new
hand-written dispatch-on-opcode site: an ``if op.opcode == 7`` in a fresh
module re-encodes semantics the table already owns, and the next opcode
lands everywhere but there.

This lint AST-scans the package for opcode dispatch sites — comparisons
(``==``/``!=``/``in``/``not in``, including ``abs(...)`` wrapping and
``match`` statements) whose subject is named ``opcode``/``oc``/``opc`` and
whose comparator involves integer constants — and fails when a file
*outside the explicit allowlist* contains one. The allowlist names every
legitimate consumer: the table itself, the declared backends that compile
it to other forms (numpy/jax kernels, C++/HDL emitters, the tracer), and
the synth fuzzer. Growing the allowlist is a reviewed act; silently
growing a new dispatch site is not.

Counterpart of ``da4ml_tpu/analysis/driftlint.py``: it scans
``da4ml_tpu_torch/`` against the port's own allowlist.
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import NamedTuple

_SUBJECT_NAMES = frozenset({'opcode', 'oc', 'opc', 'opr'})

#: files allowed to dispatch on opcodes, with the reason. Paths are relative
#: to the repository root (the ``da4ml_tpu_torch`` package's parent).
ALLOWLIST: dict[str, str] = {
    'da4ml_tpu_torch/ir/optable.py': 'the declarative opcode table itself',
    'da4ml_tpu_torch/ir/comb.py': 'binary stream encoder (opcode-8 table padding) over table-generated replay',
    'da4ml_tpu_torch/ir/dais_binary.py': 'binary stream causality validator (struct-of-arrays fast path)',
    'da4ml_tpu_torch/ir/fuse.py': 'pipeline fuser: seam lowering replaces boundary copies; binary round-trip pads opcode-8 tables (fused output conformance-checked vs staged execution)',
    'da4ml_tpu_torch/ir/schedule.py': 'levelizer: dependency-field usage via table-exported sets',
    'da4ml_tpu_torch/runtime/numpy_backend.py': 'vectorized interpreter backend (conformance-checked vs the reference)',
    'da4ml_tpu_torch/runtime/torch_backend.py': 'executor host boundary: input scales from the copy ops (conformance-checked vs the reference)',
    'da4ml_tpu_torch/trace/tracer.py': 'IR producer: encodes traced ops into opcodes',
    'da4ml_tpu_torch/trace/pipeline.py': 'retimer: splits on quantize-family boundaries',
    # C++/HDL layers: emit per-opcode source text; semantics validated by
    # the bit-exactness suites, not regenerable from python callables
    'da4ml_tpu_torch/codegen/rtl/verilog/comb.py': 'HDL emitter (C++/HDL layer allowance)',
    'da4ml_tpu_torch/codegen/rtl/vhdl/comb.py': 'HDL emitter (C++/HDL layer allowance)',
    'da4ml_tpu_torch/codegen/hls/hls_codegen.py': 'HLS emitter (C++/HDL layer allowance)',
}


class DispatchSite(NamedTuple):
    path: str  # repo-relative posix path
    lineno: int
    snippet: str


def _names_opcode(node: ast.expr) -> bool:
    """Does this expression reference an opcode-ish value?"""
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) and node.func.id == 'abs' and node.args:
        return _names_opcode(node.args[0])
    if isinstance(node, ast.Name):
        return node.id in _SUBJECT_NAMES
    if isinstance(node, ast.Attribute):
        return node.attr in _SUBJECT_NAMES
    if isinstance(node, ast.Subscript):
        return _names_opcode(node.value)
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) and node.func.id == 'int' and node.args:
        return _names_opcode(node.args[0])
    return False


def _has_int_constant(node: ast.expr) -> bool:
    if isinstance(node, ast.Constant):
        return isinstance(node.value, int) and not isinstance(node.value, bool)
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        return _has_int_constant(node.operand)
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        return any(_has_int_constant(e) for e in node.elts)
    return False


class _Scanner(ast.NodeVisitor):
    def __init__(self, path: str, source_lines: list[str]):
        self.path = path
        self.lines = source_lines
        self.sites: list[DispatchSite] = []

    def _record(self, node: ast.AST):
        line = self.lines[node.lineno - 1].strip() if node.lineno - 1 < len(self.lines) else ''
        self.sites.append(DispatchSite(self.path, node.lineno, line))

    def visit_Compare(self, node: ast.Compare):
        subjects = [node.left, *node.comparators]
        if any(_names_opcode(s) for s in subjects) and any(_has_int_constant(s) for s in subjects):
            if any(isinstance(op, (ast.Eq, ast.NotEq, ast.In, ast.NotIn)) for op in node.ops):
                self._record(node)
        self.generic_visit(node)

    def visit_Match(self, node: ast.Match):
        if _names_opcode(node.subject):
            self._record(node)
        self.generic_visit(node)


def scan_file(path: Path, rel: str) -> list[DispatchSite]:
    source = path.read_text()
    try:
        tree = ast.parse(source)
    except SyntaxError:
        return []
    scanner = _Scanner(rel, source.splitlines())
    scanner.visit(tree)
    return scanner.sites


def lint_opcodes(root: str | Path | None = None) -> tuple[list[DispatchSite], list[str]]:
    """Scan the package for opcode dispatch sites.

    Returns ``(violations, stale_allowlist)``: sites in files outside the
    allowlist, and allowlist entries whose file no longer has any site
    (or no longer exists) — both fail the lint, so the allowlist cannot rot.
    """
    if root is None:
        root = Path(__file__).resolve().parents[2]
    root = Path(root)
    pkg = root / 'da4ml_tpu_torch'
    by_file: dict[str, list[DispatchSite]] = {}
    for path in sorted(pkg.rglob('*.py')):
        rel = path.relative_to(root).as_posix()
        sites = scan_file(path, rel)
        if sites:
            by_file[rel] = sites
    violations = [s for rel, sites in by_file.items() if rel not in ALLOWLIST for s in sites]
    stale = [rel for rel in ALLOWLIST if rel not in by_file]
    return violations, stale


def lint_opcodes_main(args) -> int:
    violations, stale = lint_opcodes(getattr(args, 'root', None))
    if not violations and not stale:
        print(f'lint-opcodes: ok ({len(ALLOWLIST)} allowlisted dispatch files, 0 untracked sites)')
        return 0
    for s in violations:
        print(f'{s.path}:{s.lineno}: untracked opcode dispatch site: {s.snippet}')
    if violations:
        print(
            'lint-opcodes: opcode dispatch outside the table consumers — route the new logic through '
            'ir/optable.py (add a row field or consume an existing one), or allowlist the file in '
            'analysis/driftlint.py with a reason'
        )
    for rel in stale:
        print(f'lint-opcodes: stale allowlist entry (no dispatch sites found): {rel}')
    return 1


def add_lint_opcodes_args(parser) -> None:
    parser.add_argument('--root', default=None, help='repository root to scan (default: the installed package root)')


__all__ = ['ALLOWLIST', 'DispatchSite', 'lint_opcodes', 'lint_opcodes_main', 'add_lint_opcodes_args', 'scan_file']
