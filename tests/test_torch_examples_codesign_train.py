"""The co-design and training examples' twins on the port
(``examples/codesign_serving_torch.py``, ``examples/train_small_torch.py``)
against the JAX examples, each pair run side by side as subprocesses on
the CPU (``tests/_example_main.py``). ``tests/test_torch_purity.py``
holds the twins' refusal to run without a card unless given
``--device cpu``.

* codesign_serving, at its defaults: the searched micro-batch, tp, spec
  and WS / OS exactly; the engine's batch slots exactly; every field of
  ``summarize`` that counts iterations, requests, tokens or blocks
  exactly (the wall-clock ``total_seconds`` and ``tokens_per_second``
  are not compared);
* train_small, at ``--steps 3 --seq-len 16``, both resuming from one
  checkpoint written at step 2 by the JAX package's ``checkpoint.save``
  (a JAX ``init_train_state`` and the data stream's step): the parameter
  count exactly, both print ``resuming from step 2``, and the twin's
  step-2 loss within 1e-5 relative of the JAX example's (the loss
  tolerance ``tests/test_torch_training.py`` holds, ROADMAP F7).

Every pair prints the same lines in the same format.
"""
import math

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from _example_main import line_formats, run_both  # noqa: E402

LOSS_REL = 1e-5
WALL_FIELDS = ("total_seconds", "tokens_per_second")


def test_codesign_twin_matches_jax():
    runs = run_both("codesign_serving", [])
    (j_lines, want), (lines, got) = runs["jax"], runs["torch"]
    assert line_formats(lines) == line_formats(j_lines)
    summary, j_summary = got.pop("summary"), want.pop("summary")
    assert got == want
    assert set(summary) == set(j_summary)
    assert {k: v for k, v in summary.items() if k not in WALL_FIELDS} == \
        {k: v for k, v in j_summary.items() if k not in WALL_FIELDS}
    assert summary["unfinished"] == 0 and summary["output_tokens"] == 64


def test_train_small_twin_resumes_jax_checkpoint(tmp_path):
    from repro.training import checkpoint as j_ckpt
    from repro.training.data import DataConfig, TokenStream
    from repro.training.train_loop import init_train_state

    from repro_torch.models import ModelConfig

    cfg = ModelConfig(name="demo-100m", vocab=32_000, d_model=768,
                      n_layers=12, n_heads=12, n_kv_heads=12, head_dim=64,
                      d_ff=3072, max_seq=512)
    stream = TokenStream(DataConfig(vocab=cfg.vocab, seq_len=16,
                                    global_batch=4))
    next(stream)
    next(stream)
    params, opt = init_train_state(jax.random.PRNGKey(0), cfg)
    j_ckpt.save(str(tmp_path), 2, {"params": params, "opt": opt},
                extra={"data_step": stream.state()})
    del params, opt

    runs = run_both("train_small", ["--steps", "3", "--seq-len", "16",
                                    "--ckpt-dir", str(tmp_path)])
    (j_lines, want), (lines, got) = runs["jax"], runs["torch"]
    assert line_formats(lines) == line_formats(j_lines)
    assert "resuming from step 2" in lines
    assert "resuming from step 2" in j_lines
    assert got["params"] == want["params"] == 137_841_408
    assert got["resumed_from"] == 2
    assert [log["step"] for log in got["logs"]] == \
        [log["step"] for log in want["logs"]] == [2]
    loss, j_loss = got["logs"][0]["loss"], want["logs"][0]["loss"]
    assert math.isfinite(loss) and math.isclose(loss, j_loss,
                                                rel_tol=LOSS_REL), \
        (loss, j_loss)
