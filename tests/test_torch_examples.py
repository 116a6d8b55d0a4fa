"""The search and serving examples' twins on the port
(``examples/quickstart_torch.py``, ``examples/serve_llm_torch.py``)
against the JAX examples, each pair run side by side as subprocesses on
the CPU (``tests/_example_main.py``: the JAX example under
``JAX_PLATFORMS=cpu``, the twin with ``--device cpu``).

* quickstart, at ``--bo-iters 1 --timeline``: the best hardware exactly
  (spec, grid, WS / OS, NoP and DRAM rates, micro-batch, tp); latency,
  energy, MC, EDP and the BO history within 1e-3 relative (the search
  goldens' tolerance); each chiplet's timeline lane the same ops in the
  same order, their ends within 1e-3 relative;
* serve_llm, engine and ``--service``, at ``--requests 4 --max-new 4``:
  per scheduler the iterations, the decode iterations, the mean TTFT in
  iterations and the mean queue depth exactly (the engine has no EOS, so
  these follow from the seeded prompt lengths alone), and the service's
  peak and capacity of blocks exactly; ``--service --wall-clock``, whose
  schedule follows the host's timing: the requests, output tokens and
  block capacity exactly and a finite wall TTFT.

Every pair prints the same lines in the same format; wall-clock numbers
(tok/s) are not compared. ``tests/test_torch_examples_codesign_train.py``
holds the other two twins.
"""
import math

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from _example_main import line_formats, run_both  # noqa: E402

REL = 1e-3
HARDWARE = ("spec", "grid", "ws", "os", "nop", "dram", "mb", "tp")
METRICS = ("latency_s", "energy_j", "mc", "edp")


def _close(got: float, want: float, what: str) -> None:
    assert math.isclose(got, want, rel_tol=REL), (what, got, want)


def test_quickstart_twin_matches_jax():
    runs = run_both("quickstart", ["--bo-iters", "1", "--timeline"])
    (j_lines, want), (lines, got) = runs["jax"], runs["torch"]
    assert line_formats(lines) == line_formats(j_lines)
    assert {k: got[k] for k in HARDWARE} == {k: want[k] for k in HARDWARE}
    for key in METRICS:
        _close(got[key], want[key], key)
    assert len(got["bo_history"]) == len(want["bo_history"]) == 2
    for i, (g, w) in enumerate(zip(got["bo_history"], want["bo_history"])):
        _close(g, w, f"bo_history[{i}]")
    assert len(got["timeline"]) == len(want["timeline"]) > 1
    for c, (lane, j_lane) in enumerate(zip(got["timeline"], want["timeline"])):
        assert [op[1:] for op in lane] == [op[1:] for op in j_lane], c
        for (end, name, row), (j_end, _, _) in zip(lane, j_lane):
            _close(end, j_end, f"chiplet {c} {name}@r{row}")


@pytest.mark.parametrize("flags", [[], ["--service"],
                                   ["--service", "--wall-clock"]],
                         ids=["engine", "service", "wall_clock"])
def test_serve_llm_twin_matches_jax(flags):
    runs = run_both("serve_llm", ["--requests", "4", "--max-new", "4",
                                  *flags])
    (j_lines, want), (lines, got) = runs["jax"], runs["torch"]
    assert line_formats(lines) == line_formats(j_lines)
    if "--wall-clock" in flags:
        # arrivals on the wall clock: the schedule follows the host's
        # timing, so only what the requests themselves fix is compared
        exact = ("requests", "output_tokens", "blocks_capacity")
    else:
        exact = ("iterations", "mean_ttft_iters", "mean_queue_depth",
                 "decode_iterations") + (
            ("blocks_peak_used", "blocks_capacity") if flags else ())
    assert list(got) == list(want) == ["vllm", "orca", "chunked_prefill"]
    for sched in got:
        assert {k: got[sched][k] for k in exact} == \
            {k: want[sched][k] for k in exact}, sched
        assert got[sched]["requests"] == 4 and got[sched]["unfinished"] == 0
        if "--wall-clock" in flags:
            assert math.isfinite(got[sched]["wall_ttft_s"]) \
                and got[sched]["wall_ttft_s"] > 0, sched
