"""The port's lint, ``tools/repro_lint_torch.py``: for each rule RT001-RT006
a snippet that fires, one that stays quiet, the firing snippet suppressed
on its flagged lines, and the ``# repro-lint: hot`` marker's part (the
hot-function rules fire only under it, in either of its two places; the
others fire either way); the tool is stdlib only and imports nothing of
``tools/repro_lint.py``; and over its default paths (the port's files) it
exits 0."""
import ast
import importlib.util
import os
import sys
import textwrap

import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(ROOT, "tools", "repro_lint_torch.py")
HOT = "  # repro-lint: hot"


def _tool():
    spec = importlib.util.spec_from_file_location("repro_lint_torch", TOOL)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod       # dataclasses look the module up
    spec.loader.exec_module(mod)
    return mod


LINT = _tool()

# rule -> (fires, stays quiet, hot-function rule); "{hot}" is where the
# marker goes
CASES = {
    "RT001": ('''
        import torch

        def f(x, lengths):{hot}
            if (lengths < 0).any():
                raise ValueError("negative length")
            assert torch.isfinite(x).all()
            return x if x.sum() > 0 else -x
        ''', '''
        import torch

        def f(x, lengths, n: int, mode="kernel"):{hot}
            if x.shape[0] > n and x.dtype == torch.float32:
                x = x[:n]
            if lengths is None or mode == "eager" or len(x) == 0:
                return x
            assert x.device == lengths.device and x.numel() > 0
            return torch.where(lengths > 0, x, -x)
        ''', True),
    "RT002": ('''
        def f(x, lengths):{hot}
            top = int(lengths.max())
            return float(x.sum()) + x.max().item(), x.cpu(), top
        ''', '''
        import torch

        def f(x, lengths):{hot}
            n = x.numel()
            return torch.clamp(lengths, max=int(n)), float(x.shape[-1])
        ''', True),
    "RT003": ('''
        import numpy as np
        import torch

        def draw(device):
            rng = np.random.default_rng()
            gen = torch.Generator(device=device)
            w = torch.empty(4).normal_()
            return rng, gen, torch.randn(3, device=device), w
        ''', '''
        import numpy as np
        import torch

        def draw(device, seed):
            rng = np.random.default_rng(seed)
            gen = torch.Generator(device=device)
            gen.manual_seed(seed)
            other = torch.Generator().manual_seed(seed)
            w = torch.empty(4).normal_(generator=other)
            return rng, torch.randn(3, generator=gen, device=device), w
        ''', False),
    "RT004": ('''
        import os

        def f(x):{hot}
            if os.environ.get("REPRO_X"):
                return x
            return os.environ["REPRO_Y"], os.getenv("REPRO_Z")
        ''', '''
        import os

        MODE = os.environ.get("REPRO_X", "a")

        def f(x, mode=MODE):{hot}
            return x if mode == "a" else -x
        ''', True),
    "RT005": ('''
        _PLAN_CACHE = {}

        def plan(x):
            key = (id(x), x.shape)
            if key not in _PLAN_CACHE:
                _PLAN_CACHE[key] = len(_PLAN_CACHE)
            return _PLAN_CACHE[key]
        ''', '''
        _PLAN_CACHE = {}

        def plan(x):
            key = (tuple(x.shape), str(x.dtype))
            if key not in _PLAN_CACHE:
                _PLAN_CACHE[key] = len(_PLAN_CACHE)
            return _PLAN_CACHE[key]

        def other(x):
            return id(x)
        ''', False),
    "RT006": ('''
        import time

        import torch
        from repro_torch.kernels import ops

        def timed(q, k, v, lengths):
            t0 = time.perf_counter()
            out = ops.decode_attention(q, k, v, lengths)
            wall = time.perf_counter() - t0
            with Timer() as t:
                torch.mm(q, q)
            return out, wall, t
        ''', '''
        import time

        import torch
        from repro_torch.kernels import ops

        def timed(q, k, v, lengths):
            t0 = time.perf_counter()
            out = ops.decode_attention(q, k, v, lengths)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            t1 = time.perf_counter()
            first = out.sum().item()
            host = sorted([3, 1, 2])
            return first, wall, time.perf_counter() - t1, host

        def host_only(xs):
            t0 = time.perf_counter()
            ys = sorted(xs)
            return ys, time.perf_counter() - t0
        ''', False),
}


def _lint(tmp_path, source: str, hot: str = HOT):
    """(active, suppressed) findings of ``source`` written under a
    ``src/repro_torch`` folder (where RT003's torch draws count)."""
    path = tmp_path / "src" / "repro_torch" / "snippet.py"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(source).replace("{hot}", hot))
    return LINT.lint_file(path)


def _rules(findings) -> set:
    return {f.rule for f in findings}


@pytest.mark.parametrize("rule", sorted(CASES))
def test_rule_fires_on_its_snippet(rule, tmp_path):
    fires, _, _ = CASES[rule]
    active, suppressed = _lint(tmp_path, fires)
    assert _rules(active) == {rule} and not suppressed, active
    assert len(active) >= 2 or rule == "RT005", active


@pytest.mark.parametrize("rule", sorted(CASES))
def test_rule_quiet_on_its_clean_snippet(rule, tmp_path):
    _, quiet, _ = CASES[rule]
    active, suppressed = _lint(tmp_path, quiet)
    assert not active and not suppressed, active


@pytest.mark.parametrize("rule", sorted(CASES))
def test_rule_suppressed_on_its_lines(rule, tmp_path):
    """A ``disable=`` comment with a reason on each flagged line silences
    the rule there; a comment naming another rule does not."""
    fires, _, _ = CASES[rule]
    active, _ = _lint(tmp_path, fires)
    lines = textwrap.dedent(fires).replace("{hot}", HOT).splitlines()
    flagged = {f.line for f in active}
    other = "RT001" if rule != "RT001" else "RT002"
    wrong = [line + f"  # repro-lint: disable={other} -- not this rule"
             if i + 1 in flagged else line for i, line in enumerate(lines)]
    still, _ = _lint(tmp_path, "\n".join(wrong))
    assert _rules(still) == {rule}
    right = [line + f"  # repro-lint: disable={rule} -- reason, ROADMAP R-9"
             if i + 1 in flagged else line for i, line in enumerate(lines)]
    active, suppressed = _lint(tmp_path, "\n".join(right))
    assert not active and {f.line for f in suppressed} == flagged


@pytest.mark.parametrize("rule", sorted(CASES))
def test_hot_marker(rule, tmp_path):
    """The hot rules fire only in a marked function, whether the marker
    is on the ``def`` line or on a comment line above it; the others fire
    with or without it."""
    fires, _, hot_rule = CASES[rule]
    cold, _ = _lint(tmp_path, fires, hot="")
    assert (rule in _rules(cold)) != hot_rule, cold
    if hot_rule:
        above = textwrap.dedent(fires).replace("\ndef ",
                                               "\n# repro-lint: hot\ndef ")
        active, _ = _lint(tmp_path, above, hot="")
        assert _rules(active) == {rule}, active


def test_nested_function_of_a_hot_function_is_hot(tmp_path):
    active, _ = _lint(tmp_path, '''
        def outer(x):{hot}
            def inner(y):
                return y.item()
            return inner(x)
        ''')
    assert _rules(active) == {"RT002"}


def test_torch_draws_count_only_in_the_package(tmp_path):
    path = tmp_path / "tools" / "snippet.py"
    path.parent.mkdir()
    path.write_text("import torch\nx = torch.randn(3)\n")
    assert LINT.lint_file(path) == ([], [])


def test_tool_is_stdlib_only():
    with open(TOOL) as f:
        tree = ast.parse(f.read())
    mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names}
    mods |= {n.module for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom)}
    assert mods == {"__future__", "argparse", "ast", "dataclasses", "re",
                    "sys", "pathlib"}
    assert [r.rule_id for r in LINT.RULES] == sorted(CASES)


def test_default_paths_are_the_ports_files():
    paths = {os.path.relpath(p, ROOT) for p in LINT.default_paths()}
    assert {"src/repro_torch", "chip_smoke.py",
            "examples/quickstart_torch.py", "examples/train_small_torch.py",
            "tools/repro_lint_torch.py",
            "tools/population_chunks_cards.py"} <= paths
    assert "tools/repro_lint.py" not in paths
    assert not any(p.startswith("src/repro/") or p == "src/repro"
                   for p in paths)


def test_port_lints_clean(capsys):
    assert LINT.main([]) == 0
    assert "0 findings" in capsys.readouterr().err
