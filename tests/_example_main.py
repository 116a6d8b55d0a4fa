"""Run one example in this process and print, as the last line of its
standard output, ``RECORD <json>``: what the example computed, unrounded.

  python tests/_example_main.py torch quickstart --bo-iters 1 --device cpu
  python tests/_example_main.py jax quickstart --bo-iters 1

``torch``: ``main(argv)`` of ``examples/<name>_torch.py``, whose returned
dict is the record. ``jax``: ``examples/<name>.py`` run as ``__main__``,
with the JAX package's functions that it calls for its printed numbers
wrapped to record their results (nothing of the JAX package changes), and
the record built as the port's twin builds its dict. The tests
(``tests/test_torch_examples*.py``) start both with :func:`run_both`.
"""
import importlib.util
import json
import os
import re
import runpy
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples")


def _example(name: str):
    path = os.path.join(EXAMPLES, f"{name}_torch.py")
    spec = importlib.util.spec_from_file_location(f"{name}_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _plain(obj):
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    raise TypeError(f"{type(obj)} is not JSON serialisable")


def _wrap(owner, attr: str, on_result) -> None:
    """Replace ``owner.attr`` by a function that calls it and passes its
    arguments and result to ``on_result``."""
    fn = getattr(owner, attr)

    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        on_result(args, out)
        return out

    setattr(owner, attr, wrapped)


def _run_jax(name: str, argv: list) -> dict:
    import repro.core as core
    import repro.core.evaluator as evaluator
    import repro.models as models
    import repro.serving.engine as engine
    import repro.serving.service as service
    import repro.training.train_loop as train_loop

    twin = _example("quickstart")
    decode_iterations = _example("serve_llm").decode_iterations
    rec: dict = {}
    _wrap(core, "explore",
          lambda a, res: rec.update(search=twin.search_record(res)))
    _wrap(evaluator, "evaluate",
          lambda a, r: rec.update(timeline=twin.timeline_lanes(*a[:3], r)))
    _wrap(engine, "summarize",
          lambda a, s: rec.setdefault("summaries", []).append(dict(
              s, decode_iterations=decode_iterations(a[1]))))
    # a service's summary calls the engine's summarize: kept apart
    _wrap(service.ServiceResult, "summary",
          lambda a, s: rec.setdefault("services", []).append(dict(
              s, blocks_peak_used=a[0].counters["blocks_peak_used"],
              blocks_capacity=a[0].counters["blocks_capacity"],
              decode_iterations=decode_iterations(a[0].stats))))
    _wrap(engine.ServingEngine, "__init__",
          lambda a, _: rec.update(engine_batch=a[0].max_batch))
    _wrap(models, "param_count", lambda a, n: rec.update(params=n))
    _wrap(train_loop, "train", lambda a, out: rec.update(logs=out[2]))

    sys.argv = [f"{name}.py", *argv]
    runpy.run_path(os.path.join(EXAMPLES, f"{name}.py"), run_name="__main__")
    if name == "quickstart":
        return {**rec["search"], "timeline": rec.get("timeline")}
    if name == "serve_llm":
        return dict(zip(("vllm", "orca", "chunked_prefill"),
                        rec.get("services", rec["summaries"])))
    if name == "codesign_serving":
        search = rec["search"]
        summary = dict(rec["summaries"][0])
        return {"micro_batch": search["mb"], "tp": search["tp"],
                "spec": search["spec"], "ws": search["ws"],
                "os": search["os"], "engine_batch": rec["engine_batch"],
                "decode_iterations": summary.pop("decode_iterations"),
                "summary": summary}
    if name == "train_small":
        return {"params": rec["params"], "logs": rec["logs"]}
    raise SystemExit(f"no example {name!r}")


def run_both(name: str, args: list, timeout: float = 600) -> dict:
    """The JAX example (``JAX_PLATFORMS=cpu``) and its twin
    (``--device cpu``) on ``args``, as two subprocesses run side by side:
    {"jax" | "torch": (printed lines, record)}."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"))
    procs = {
        package: subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), package, name, *args,
             *(["--device", "cpu"] if package == "torch" else [])],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd=ROOT)
        for package in ("jax", "torch")}
    out = {}
    for package, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=timeout)
        lines = stdout.splitlines()
        assert proc.returncode == 0 and lines \
            and lines[-1].startswith("RECORD "), \
            (package, name, proc.returncode, stdout[-2000:], stderr[-4000:])
        out[package] = (lines[:-1], json.loads(lines[-1][len("RECORD "):]))
    return out


NUMBER = re.compile(r"[-+]?\d+(\.\d+)?(e[-+]?\d+)?")


def line_formats(lines: list) -> list:
    """Printed lines with every number read as ``#`` and runs of blanks
    as one: what the two scripts must print alike."""
    return [" ".join(NUMBER.sub("#", line).split()) for line in lines]


def main() -> None:
    package, name, *argv = sys.argv[1:]
    sys.path.insert(0, os.path.join(ROOT, "src"))
    if package == "torch":
        out = _example(name).main(argv)
    else:
        out = _run_jax(name, argv)
    sys.stdout.flush()
    print("RECORD " + json.dumps(out, default=_plain), flush=True)


if __name__ == "__main__":
    main()
