#!/usr/bin/env python3
"""repro_lint_torch — the PyTorch/CUDA port's static analysis (AST-based).

The port's counterpart of ``tools/repro_lint.py``. The port has no
``jit``: its hazards are eager torch's. A value read back from the card
stalls the host until the device has caught up, an environment read is a
host cost on every call and a knob that can change in mid-run, and a host
timer that stops before the device has finished measures the enqueue.
Each rule is a :class:`LintRule` visitor over one file's AST:

=======  ==================================================================
rule     meaning
=======  ==================================================================
RT001    ``if`` / ``while`` / ``assert`` (or a conditional expression) on
         a tensor's value inside a hot function: an implicit
         device-to-host sync. Metadata (``.shape``, ``.dtype``,
         ``.device``, ``.numel()``, ``len``, ``is None``) is not a value.
RT002    ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``, or
         ``float`` / ``int`` / ``bool`` of a tensor, inside a hot
         function: an explicit device-to-host copy.
RT003    unseeded randomness: ``np.random.default_rng()`` with no seed; a
         ``torch.Generator`` that is never ``manual_seed``-ed; under
         ``src/repro_torch``, ``torch.rand*`` / ``randn*`` / ``randint*``
         / ``randperm`` / ``normal`` / ``bernoulli`` / ``multinomial`` or
         a tensor's ``normal_`` / ``uniform_`` / ... with no
         ``generator=``.
RT004    environment read (``os.environ`` / ``os.getenv``) inside a hot
         function: torch reads it on every call, a host cost per call and
         a knob that changes in mid-run.
RT005    ``id(...)`` in a function that keys a module-level cache: ids
         recycle after garbage collection, so the cache must provably
         retain the keyed objects (suppress with that argument).
RT006    a host timer (a ``time.perf_counter()`` / ``time.time()`` /
         ``time.monotonic()`` start and a ``<timer>() - start`` stop, or a
         ``Timer`` block) around device work with no
         ``torch.cuda.synchronize()``, ``<event>.synchronize()``,
         ``<event>.elapsed_time(...)`` or read-back (``.item()``,
         ``.tolist()``, ``.cpu()``, ``.numpy()``) before the stop: CUDA
         launches return before the device finishes.
=======  ==================================================================

A hot function is marked by ``# repro-lint: hot`` on its ``def`` line
(any line of a signature that spans several) or on a standalone comment
line directly above it; RT001, RT002 and RT004 look only inside hot
functions (nested functions included). Device work, for
RT006, is a call into ``torch`` or into the port (``repro_torch`` or a
relative import).

Suppression: append ``# repro-lint: disable=RT002`` to the offending line
(or put it on a standalone comment line directly above); several ids may
be comma-separated. Run: ``python tools/repro_lint_torch.py [paths...]``
(default: the port's files — ``src/repro_torch``, ``chip_smoke.py``,
``examples/*_torch.py`` and the ``tools/`` scripts other than
``tools/repro_lint.py``); exits 1 on any unsuppressed finding.

Uses only the stdlib, and imports nothing of ``tools/repro_lint.py``.
"""
from __future__ import annotations

import argparse
import ast
import dataclasses
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# rule ids after "disable="; a reason may follow them
SUPPRESS_RE = re.compile(r"#\s*repro-lint:\s*disable=((?:[A-Z]{2}\d{3}[,\s]*)+)")
HOT_RE = re.compile(r"#\s*repro-lint:\s*hot\b")

# tensor attributes and methods that read metadata, not values (RT001)
META_ATTRS = frozenset((
    "shape", "dtype", "device", "ndim", "is_cuda", "layout",
    "requires_grad", "is_leaf", "names", "grad_fn"))
META_METHODS = (
    "size", "dim", "numel", "nelement", "stride", "data_ptr",
    "is_contiguous", "element_size", "get_device", "is_floating_point",
    "is_complex", "storage_offset", "untyped_storage")
# torch callables that return no tensor
TORCH_HOST = frozenset((
    "torch.device", "torch.Size", "torch.Generator", "torch.is_tensor",
    "torch.is_floating_point", "torch.finfo", "torch.iinfo",
    "torch.get_default_dtype", "torch.no_grad", "torch.inference_mode",
    "torch.enable_grad", "torch.is_grad_enabled"))
READ_BACKS = ("item", "tolist", "cpu", "numpy")          # RT002 methods
HOST_CASTS = ("float", "int", "bool")
# RT003
TORCH_RANDOM = frozenset((
    "rand", "rand_like", "randn", "randn_like", "randint", "randint_like",
    "randperm", "normal", "bernoulli", "multinomial", "poisson"))
INPLACE_RANDOM = frozenset((
    "normal_", "uniform_", "random_", "bernoulli_", "exponential_",
    "geometric_", "cauchy_", "log_normal_"))
# RT006
TIMERS = ("time.perf_counter", "time.time", "time.monotonic",
          "time.perf_counter_ns", "time.monotonic_ns")
SYNC_METHODS = ("synchronize", "elapsed_time") + READ_BACKS


@dataclasses.dataclass(frozen=True)
class Finding:
    path: str
    line: int
    col: int
    rule: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"


def dotted_name(node: ast.AST) -> "str | None":
    """``torch.cuda.synchronize`` -> "torch.cuda.synchronize"; None for
    anything but a chain of names."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _annotation_is_host(node: "ast.AST | None") -> bool:
    """True when a parameter is annotated, and its annotation does not
    name ``Tensor``."""
    if node is None:
        return False
    text = node.value if isinstance(node, ast.Constant) \
        and isinstance(node.value, str) else ast.unparse(node)
    return "Tensor" not in text


class FileContext:
    """Per-file pre-pass shared by every rule: the import map, the
    suppressions, the hot functions and the module-level names."""

    def __init__(self, path: Path, source: str, tree: ast.Module):
        self.path = path
        self.tree = tree
        self.lines = source.splitlines()
        self.aliases: dict[str, str] = {}       # local name -> dotted module
        self.from_imports: dict[str, str] = {}  # local name -> module.attr
        self.suppressions = self._parse_suppressions(self.lines)
        self._collect_imports(tree)
        self.functions = [n for n in ast.walk(tree)
                          if isinstance(n, (ast.FunctionDef,
                                            ast.AsyncFunctionDef))]
        self.hot = [fn for fn in self.functions if self._is_hot(fn)]
        self.module_names = {
            t.id for node in tree.body
            if isinstance(node, (ast.Assign, ast.AnnAssign))
            for t in (node.targets if isinstance(node, ast.Assign)
                      else [node.target])
            if isinstance(t, ast.Name)}
        parts = path.resolve().parts
        self.in_package = any(parts[i:i + 2] == ("src", "repro_torch")
                              for i in range(len(parts) - 1))

    @staticmethod
    def _parse_suppressions(lines) -> "dict[int, set[str]]":
        """line number -> suppressed rule ids. A suppression on a
        standalone comment line also covers the next line."""
        out: dict[int, set[str]] = {}
        for i, line in enumerate(lines, start=1):
            m = SUPPRESS_RE.search(line)
            if not m:
                continue
            rules = {r.strip().upper() for r in m.group(1).split(",")
                     if r.strip()}
            out.setdefault(i, set()).update(rules)
            if line.lstrip().startswith("#"):       # standalone comment
                out.setdefault(i + 1, set()).update(rules)
        return out

    def _collect_imports(self, tree: ast.Module) -> None:
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.aliases[a.asname or a.name.split(".")[0]] = \
                        a.name if a.asname else a.name.split(".")[0]
            elif isinstance(node, ast.ImportFrom):
                module = "." * node.level + (node.module or "")
                for a in node.names:
                    self.from_imports[a.asname or a.name] = \
                        f"{module}.{a.name}" if node.module or not node.level \
                        else f"{module}{a.name}"

    def resolve(self, node: ast.AST) -> "str | None":
        """A name or attribute chain in its fully qualified form through
        the imports (``F.pad`` -> ``torch.nn.functional.pad``)."""
        name = dotted_name(node)
        if name is None:
            return None
        root, _, rest = name.partition(".")
        base = self.aliases.get(root) or self.from_imports.get(root)
        if base is None:
            return name
        return f"{base}.{rest}" if rest else base

    def _is_hot(self, fn) -> bool:
        """The marker on a line of the signature, or on a standalone
        comment line directly above the ``def`` (or its decorators)."""
        first = min([fn.lineno] + [d.lineno for d in fn.decorator_list])
        above = self.lines[first - 2] if first >= 2 else ""
        sig = self.lines[fn.lineno - 1:max(fn.body[0].lineno - 1,
                                           fn.lineno)]
        return any(HOT_RE.search(line) for line in sig) or (
            above.lstrip().startswith("#") and bool(HOT_RE.search(above)))

    def is_device_call(self, node: ast.Call) -> bool:
        """A call into ``torch`` or into the port."""
        name = self.resolve(node.func) or ""
        return name.startswith(("torch.", "repro_torch.", ".")) \
            and name not in TORCH_HOST


class TensorNames:
    """Which expressions of one function are tensors, as far as its text
    shows: parameters not annotated with a host type, and names assigned
    from a ``torch`` call or from an expression over tensors."""

    def __init__(self, ctx: FileContext, fn):
        self.ctx = ctx
        self.names = set()
        for node in ast.walk(fn):           # nested functions' too
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                self.names |= self._tensor_params(node.args)
        assigns = [n for n in ast.walk(fn) if isinstance(n, ast.Assign)]
        for _ in range(3):                      # names feed later names
            for node in assigns:
                if self.is_tensor(node.value):
                    for t in node.targets:
                        for n in ast.walk(t):
                            if isinstance(n, ast.Name):
                                self.names.add(n.id)

    @staticmethod
    def _tensor_params(args: ast.arguments) -> set:
        """Parameters but ``self`` / ``cls``, those annotated with a host
        type and those with a constant default other than None."""
        params = args.posonlyargs + args.args + args.kwonlyargs
        defaults = [None] * (len(args.posonlyargs + args.args)
                             - len(args.defaults)) + list(args.defaults) \
            + list(args.kw_defaults)
        return {a.arg for a, d in zip(params, defaults)
                if a.arg not in ("self", "cls")
                and not _annotation_is_host(a.annotation)
                and not (isinstance(d, ast.Constant)
                         and d.value is not None)}

    def is_tensor(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.names
        if isinstance(node, ast.Attribute):
            return node.attr not in META_ATTRS and self.is_tensor(node.value)
        if isinstance(node, ast.Subscript):
            return self.is_tensor(node.value)
        if isinstance(node, ast.Call):
            name = self.ctx.resolve(node.func) or ""
            if name.startswith("torch."):
                return name not in TORCH_HOST and not name.startswith(
                    "torch.cuda.")
            if isinstance(node.func, ast.Attribute):
                return node.func.attr not in META_METHODS + READ_BACKS \
                    and self.is_tensor(node.func.value)
            return False
        if isinstance(node, ast.BinOp):
            return self.is_tensor(node.left) or self.is_tensor(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.is_tensor(node.operand)
        if isinstance(node, ast.BoolOp):
            return any(self.is_tensor(v) for v in node.values)
        if isinstance(node, ast.Compare):
            operands = [node.left, *node.comparators]
            if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                   for op in node.ops) or any(map(self._is_host, operands)):
                return False
            return any(map(self.is_tensor, operands))
        if isinstance(node, ast.IfExp):
            return self.is_tensor(node.body) or self.is_tensor(node.orelse)
        return False

    @staticmethod
    def _is_host(node: ast.AST) -> bool:
        """A string, or metadata (``x.shape``, ``x.shape[0]``,
        ``x.numel()``, ``len(x)``, ``tuple(x.shape)``): a comparison with
        one is decided on the host."""
        if isinstance(node, ast.Constant):
            return isinstance(node.value, str)
        if isinstance(node, ast.Subscript):
            node = node.value
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id in ("len", "tuple", "list") and node.args:
            return node.func.id == "len" or \
                TensorNames._is_host(node.args[0])
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            return node.func.attr in META_METHODS
        return isinstance(node, ast.Attribute) and node.attr in META_ATTRS



class LintRule:
    """One pluggable check. Subclasses set ``rule_id`` / ``description``
    and implement ``check(ctx) -> list[Finding]``."""

    rule_id = "RT000"
    description = ""

    def check(self, ctx: FileContext) -> "list[Finding]":
        raise NotImplementedError

    def finding(self, ctx: FileContext, node: ast.AST,
                message: str) -> Finding:
        return Finding(str(ctx.path), getattr(node, "lineno", 1),
                       getattr(node, "col_offset", 0), self.rule_id, message)


class TensorBranchRule(LintRule):
    rule_id = "RT001"
    description = ("if/while/assert on a tensor's value inside a hot "
                   "function (an implicit device-to-host sync)")

    def check(self, ctx):
        out = []
        for fn in ctx.hot:
            tensors = TensorNames(ctx, fn)
            for node in ast.walk(fn):
                if isinstance(node, (ast.If, ast.While, ast.Assert,
                                     ast.IfExp)) \
                        and tensors.is_tensor(node.test):
                    kind = type(node).__name__.lower()
                    out.append(self.finding(
                        ctx, node,
                        f"`{kind}` on a tensor's value inside hot function "
                        f"`{fn.name}` waits for the device — decide on the "
                        "host's own data, or keep it on the device "
                        "(torch.where)"))
        return out


class ReadBackRule(LintRule):
    rule_id = "RT002"
    description = (".item()/.tolist()/.cpu()/.numpy() or float/int/bool of "
                   "a tensor inside a hot function")

    def check(self, ctx):
        out = []
        for fn in ctx.hot:
            tensors = TensorNames(ctx, fn)
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                what = None
                if isinstance(node.func, ast.Attribute) \
                        and node.func.attr in READ_BACKS and not node.args \
                        and (node.func.attr in ("cpu", "numpy")
                             or tensors.is_tensor(node.func.value)):
                    what = f".{node.func.attr}()"
                elif isinstance(node.func, ast.Name) \
                        and node.func.id in HOST_CASTS \
                        and len(node.args) == 1 \
                        and tensors.is_tensor(node.args[0]):
                    what = f"{node.func.id}(<tensor>)"
                if what:
                    out.append(self.finding(
                        ctx, node,
                        f"{what} inside hot function `{fn.name}` copies a "
                        "value back from the device and waits for it"))
        return out


class UnseededRandomRule(LintRule):
    rule_id = "RT003"
    description = ("unseeded randomness: default_rng(), an unseeded "
                   "torch.Generator, torch random draws without generator=")

    def check(self, ctx):
        out = []
        parents = {child: node for node in ast.walk(ctx.tree)
                   for child in ast.iter_child_nodes(node)}
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = ctx.resolve(node.func) or ""
            if name == "numpy.random.default_rng" and not node.args \
                    and not node.keywords:
                out.append(self.finding(
                    ctx, node, "unseeded default_rng() — seed it (the "
                    "port's contracts are bit for bit)"))
            elif name == "torch.Generator" \
                    and not self._seeded(ctx, node, parents):
                out.append(self.finding(
                    ctx, node, "torch.Generator never manual_seed-ed — "
                    "seed it"))
            elif ctx.in_package and not any(k.arg == "generator"
                                             for k in node.keywords):
                draw = (name.startswith("torch.")
                        and name.rpartition(".")[2] in TORCH_RANDOM) or (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr in INPLACE_RANDOM)
                if draw:
                    out.append(self.finding(
                        ctx, node, f"`{dotted_name(node.func)}` draws from "
                        "torch's global generator — pass a seeded "
                        "generator="))
        return out

    @staticmethod
    def _seeded(ctx, node, parents) -> bool:
        """The generator is seeded where it is made
        (``torch.Generator(...).manual_seed(s)``) or, when bound to a name
        or attribute, by a ``<target>.manual_seed(...)`` call in the same
        function (or module)."""
        parent = parents.get(node)
        if isinstance(parent, ast.Attribute) and parent.attr == "manual_seed":
            return True
        if not isinstance(parent, ast.Assign):
            return False
        scope = parent
        while scope in parents and not isinstance(
                scope, (ast.FunctionDef, ast.AsyncFunctionDef)):
            scope = parents[scope]
        targets = {dotted_name(t) for t in parent.targets}
        return any(isinstance(n, ast.Call)
                   and isinstance(n.func, ast.Attribute)
                   and n.func.attr == "manual_seed"
                   and dotted_name(n.func.value) in targets
                   for n in ast.walk(scope))


class EnvReadRule(LintRule):
    rule_id = "RT004"
    description = "environment read inside a hot function"

    def check(self, ctx):
        out = []
        for fn in ctx.hot:
            for node in ast.walk(fn):
                resolved = None
                if isinstance(node, ast.Call):
                    resolved = ctx.resolve(node.func)
                elif isinstance(node, ast.Subscript):
                    resolved = ctx.resolve(node.value)
                if resolved in ("os.getenv", "os.environ.get", "os.environ"):
                    out.append(self.finding(
                        ctx, node,
                        f"environment read inside hot function `{fn.name}` "
                        "— a host cost on every call, and a knob that can "
                        "change in mid-run; read it once, outside"))
        return out


class IdentityCacheKeyRule(LintRule):
    rule_id = "RT005"
    description = "id(...) in a function that keys a module-level cache"

    def check(self, ctx):
        caches = {n for n in ctx.module_names if "CACHE" in n.upper()}
        out = []
        for fn in ctx.functions:
            names = {n.id for n in ast.walk(fn) if isinstance(n, ast.Name)}
            if not names & caches:
                continue
            for node in ast.walk(fn):
                if isinstance(node, ast.Call) \
                        and isinstance(node.func, ast.Name) \
                        and node.func.id == "id":
                    out.append(self.finding(
                        ctx, node,
                        f"id(...) feeds a cache key in `{fn.name}` — ids "
                        "recycle after gc; the cache must retain the keyed "
                        "objects (suppress with the retention argument if "
                        "it provably does)"))
        return out


class TimerWithoutSyncRule(LintRule):
    rule_id = "RT006"
    description = ("host timer around device work with no synchronize, "
                   "elapsed_time or read-back before it stops")

    def _is_timer(self, ctx, node) -> bool:
        return isinstance(node, ast.Call) and ctx.resolve(node.func) in TIMERS

    @staticmethod
    def _is_sync(node) -> bool:
        return isinstance(node, ast.Call) \
            and isinstance(node.func, ast.Attribute) \
            and node.func.attr in SYNC_METHODS

    def _span(self, ctx, calls, start: int, stop: int):
        """(a device call, a sync) among ``calls`` on lines start..stop."""
        inside = [c for c in calls if start <= c.lineno <= stop]
        device = [c for c in inside if ctx.is_device_call(c)]
        return device, any(self._is_sync(c) for c in inside)

    def check(self, ctx):
        out = []
        for fn in ctx.functions:
            calls = [n for n in ast.walk(fn) if isinstance(n, ast.Call)]
            starts = {}
            for node in ast.walk(fn):
                if isinstance(node, ast.Assign) \
                        and self._is_timer(ctx, node.value):
                    for t in node.targets:
                        if isinstance(t, (ast.Name, ast.Attribute)):
                            starts.setdefault(dotted_name(t), []).append(
                                node.lineno)
            for node in ast.walk(fn):
                if not (isinstance(node, ast.BinOp)
                        and isinstance(node.op, ast.Sub)
                        and self._is_timer(ctx, node.left)):
                    continue
                began = [line for line in starts.get(
                    dotted_name(node.right), []) if line < node.lineno]
                if not began:
                    continue
                device, synced = self._span(ctx, calls, max(began) + 1,
                                            node.lineno)
                if device and not synced:
                    out.append(self.finding(
                        ctx, node,
                        f"timer in `{fn.name}` stops around device work "
                        f"(`{dotted_name(device[0].func)}`) with no "
                        "synchronize or read-back before it — it times the "
                        "enqueue"))
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.With) and any(
                    isinstance(item.context_expr, ast.Call)
                    and (ctx.resolve(item.context_expr.func) or "")
                    .split(".")[-1] == "Timer" for item in node.items):
                calls = [n for b in node.body for n in ast.walk(b)
                         if isinstance(n, ast.Call)]
                device = [c for c in calls if ctx.is_device_call(c)]
                if device and not any(self._is_sync(c) for c in calls):
                    out.append(self.finding(
                        ctx, node,
                        "Timer block dispatches device work "
                        f"(`{dotted_name(device[0].func)}`) but never "
                        "synchronizes before it ends"))
        return out


RULES: "list[LintRule]" = [
    TensorBranchRule(), ReadBackRule(), UnseededRandomRule(), EnvReadRule(),
    IdentityCacheKeyRule(), TimerWithoutSyncRule(),
]


def lint_file(path: Path) -> "tuple[list[Finding], list[Finding]]":
    """Returns (active findings, suppressed findings)."""
    source = path.read_text()
    try:
        tree = ast.parse(source, filename=str(path))
    except SyntaxError as e:
        return [Finding(str(path), e.lineno or 1, e.offset or 0, "RT000",
                        f"syntax error: {e.msg}")], []
    ctx = FileContext(path, source, tree)
    active: list[Finding] = []
    suppressed: list[Finding] = []
    for rule in RULES:
        for f in rule.check(ctx):
            if f.rule in ctx.suppressions.get(f.line, set()):
                suppressed.append(f)
            else:
                active.append(f)
    return active, suppressed


def default_paths() -> "list[str]":
    """The port's files: its package, ``chip_smoke.py``, the examples'
    twins and the ``tools/`` scripts other than the JAX package's lint."""
    tools = sorted(p for p in (ROOT / "tools").glob("*.py")
                   if p.name != "repro_lint.py")
    return [str(p) for p in (ROOT / "src" / "repro_torch",
                             ROOT / "chip_smoke.py",
                             *sorted((ROOT / "examples").glob("*_torch.py")),
                             *tools)]


def iter_py_files(paths: "list[str]"):
    for p in paths:
        path = Path(p)
        if path.is_dir():
            yield from sorted(path.rglob("*.py"))
        elif path.suffix == ".py":
            yield path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="the port's eager-torch lint (rules RT001-RT006)")
    ap.add_argument("paths", nargs="*",
                    help="files or directories (default: the port's files)")
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument("--show-suppressed", action="store_true",
                    help="also print findings silenced by disable comments")
    args = ap.parse_args(argv)
    if args.list_rules:
        for r in RULES:
            print(f"{r.rule_id}  {r.description}")
        return 0
    n_files = 0
    active: list[Finding] = []
    suppressed: list[Finding] = []
    for path in iter_py_files(args.paths or default_paths()):
        n_files += 1
        a, s = lint_file(path)
        active.extend(a)
        suppressed.extend(s)
    for f in active:
        print(f)
    if args.show_suppressed:
        for f in suppressed:
            print(f"{f} [suppressed]")
    status = "FAILED" if active else "ok"
    print(f"repro-lint-torch: {n_files} files, {len(active)} findings "
          f"({len(suppressed)} suppressed) — {status}", file=sys.stderr)
    return 1 if active else 0


if __name__ == "__main__":
    raise SystemExit(main())
