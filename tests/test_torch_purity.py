"""The port stands alone: its main path loads no JAX and no module of the
JAX package, no file of it imports either (its package, ``chip_smoke.py``,
the examples' twins ``examples/*_torch.py`` and its ``tools/`` scripts
other than the two that compare it with the JAX package), and its entry
points, the twins included, run on CUDA by default — raising, not falling
back to the CPU, where there is no CUDA device."""
import ast
import glob
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from _example_main import _example  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "src", "repro_torch")
FORBIDDEN = ("jax", "jaxlib", "repro")
# tools that hold the port against the JAX package, as the tests do, and
# the JAX package's own lint
NOT_PORT_TOOLS = ("mixed_precision_gaps.py", "scan_int8_gaps.py",
                  "repro_lint.py")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_main_path_imports_no_jax_and_no_reference():
    code = (
        "import sys\n"
        "import repro_torch.core.compass, repro_torch.core.torch_evaluator\n"
        "import repro_torch.kernels.ops, repro_torch.core.observability\n"
        "import repro_torch.serving.engine, repro_torch.launch.serve\n"
        "import repro_torch.models, repro_torch.configs\n"
        "import repro_torch.models.mamba2, repro_torch.kernels.ssd_scan\n"
        "import repro_torch.core.baselines, repro_torch.core.frontier\n"
        "import repro_torch.analysis.fuzz, repro_torch.serving.service\n"
        "import repro_torch.models.paged, repro_torch.fleet\n"
        "import repro_torch.configs.phi_3_vision_4_2b\n"
        "import repro_torch.tuning, repro_torch.models.stacked\n"
        "import repro_torch.configs.whisper_tiny, repro_torch.dist\n"
        "import repro_torch.dist.compression, repro_torch.training\n"
        "import repro_torch.training.train_loop\n"
        "import repro_torch.training.checkpoint\n"
        "import repro_torch.dist.sharding, repro_torch.dist.elastic\n"
        "import repro_torch.launch.mesh, repro_torch.launch.train\n"
        "import repro_torch.launch.roofline, repro_torch.launch.dryrun\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'jaxlib', "
        "'repro') or m.startswith(('jax.', 'jaxlib.', 'repro.')))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _imports(path: str):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


def test_no_file_of_the_port_imports_jax_or_the_reference():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PORT):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    twins = glob.glob(os.path.join(ROOT, "examples", "*_torch.py"))
    tools = [p for p in glob.glob(os.path.join(ROOT, "tools", "*.py"))
             if os.path.basename(p) not in NOT_PORT_TOOLS]
    assert len(twins) == 4 and len(tools) >= 7
    files += twins + tools
    assert len(files) > 20
    bad = [f"{os.path.relpath(p, ROOT)}:{line}: {mod}"
           for p in files for line, mod in _imports(p) if _forbidden(mod)]
    assert not bad, bad


def test_default_device_is_cuda_and_never_falls_back():
    from repro_torch.core import compass, timing, torch_evaluator
    from repro_torch.core.hardware import make_hardware
    from repro_torch.core.streams import RequestStream
    from repro_torch.core.workload import (
        LLMSpec,
        build_execution_graph,
        prefill_request,
    )

    spec = LLMSpec("tiny", 512, 8, 8, 64, 2048, 32000, 8)
    hw = make_hardware(64, "M", tensor_parallel=2)
    batches = [[prefill_request(64), prefill_request(128)]]
    g = build_execution_graph(spec, batches[0], 2, tp=2, n_blocks=1)
    scenario = compass.Scenario("t", spec, target_tops=64, n_blocks=1,
                                stream=RequestStream.fixed_batches(batches))
    from repro_torch.configs import get
    from repro_torch.launch import serve
    from repro_torch.launch import train as launch_train
    from repro_torch.models import init_cache, init_model, prefill
    from repro_torch.serving.engine import ServingEngine

    cfg = get("qwen1.5-0.5b").reduced()
    params = init_model(cfg, device="cpu")
    cache = init_cache(cfg, 1, 8, device="cpu")
    m_cfg = get("mamba2-2.7b").reduced()
    m_params = init_model(m_cfg, device="cpu")
    m_cache = init_cache(m_cfg, 1, 8, device="cpu")
    tokens = torch.zeros((1, 4), dtype=torch.int64)
    calls = [
        lambda: timing.resolve_device(None),
        lambda: init_model(cfg),
        lambda: init_cache(cfg, 1, 8),
        lambda: ServingEngine(params, cfg),
        lambda: prefill(params, cfg, tokens, cache),
        lambda: init_cache(m_cfg, 1, 8),
        lambda: prefill(m_params, m_cfg, tokens, m_cache),
        lambda: serve.main([]),
        lambda: serve.main(["--arch", "mamba2-2.7b"]),
        lambda: launch_train.main(["--reduced", "--steps", "1"]),
        lambda: compass.search_mapping(spec, batches, hw, [2], n_blocks=1),
        lambda: compass.explore(scenario, bo_iters=1, bo_init=1),
        lambda: torch_evaluator.PopulationEvaluator(
            g, timing.get_cost_tables(g, ("t",), hw), hw),
        lambda: timing.FusedTimingBackend().pass_b(
            [[1.0]], [[0]], [[[1]]], 1),
        lambda: _example("quickstart").main(["--bo-iters", "1"]),
        lambda: _example("serve_llm").main(["--requests", "1"]),
        lambda: _example("serve_llm").main(["--service"]),
        lambda: _example("codesign_serving").main([]),
        lambda: _example("train_small").main(["--steps", "1"]),
    ]
    if torch.cuda.is_available():
        assert timing.resolve_device(None) == torch.device("cuda")
        return
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert timing.resolve_device("cpu") == torch.device("cpu")
