"""The port's dist and launch modules (``dist/{sharding,elastic}``,
``launch/{mesh,roofline,dryrun,train}``) against the JAX package's:

* every case of ``tests/test_sharding.py`` on the port's modules, and each
  rule's spec equal to ``repro.dist.sharding``'s for every stacked
  parameter and cache leaf of every assigned config at full width, on
  both production meshes and the (1, 1) mesh;
* the port's stacked leaf names and shapes equal to ``jax.eval_shape`` of
  the reference's stacked trees on the reduced configs;
* the dry run's whisper-tiny ``decode_32k`` argument bytes equal to the
  sum over the reference's own abstract inputs under its specs; counted
  FLOPs of a 2-layer reduced llama ``prefill`` equal to a hand count;
* ``roofline.analyse`` equal to the reference's on synthetic records of
  every assigned arch x shape under the TPU's constants, and its null
  fields;
* the launcher on reduced qwen1.5-0.5b: 4 steps, a resume from step 2
  with bitwise-equal losses, a resume from the JAX launcher's step-8
  checkpoint against the JAX launcher's own 12 steps, and its refusal of
  more than one device.

``repro.launch.dryrun`` is never imported here: it sets ``XLA_FLAGS`` at
import."""
import dataclasses
import functools
import json
import math
import os
import re
import shutil
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.dist import elastic as j_elastic  # noqa: E402
from repro.dist import sharding as j_sharding  # noqa: E402
from repro.launch import roofline as j_roofline  # noqa: E402
from repro.models import init_cache as j_init_cache  # noqa: E402
from repro.models import init_model as j_init_model  # noqa: E402
from repro.models.stacked import stack_cache as j_stack_cache  # noqa: E402
from repro.models.stacked import stack_params as j_stack_params  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.dist import elastic, sharding  # noqa: E402
from repro_torch.dist.sharding import (  # noqa: E402
    cache_partition_spec,
    constrain,
    make_cache_shardings,
    make_param_shardings,
    param_partition_spec,
)
from repro_torch.launch import dryrun, roofline  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    Mesh,
    make_mesh,
    make_production_mesh,
)
from repro_torch.models import init_cache, init_model  # noqa: E402
from repro_torch.models.stacked import stack_cache, stack_params  # noqa: E402
from repro_torch.training.optimizer import named_leaves  # noqa: E402

P = jax.sharding.PartitionSpec


class FakeMesh:
    axis_names = ("pod", "data", "model")
    shape = {"pod": 2, "data": 16, "model": 16}


MESHES = {"16x16": make_production_mesh(),
          "2x16x16": make_production_mesh(multi_pod=True),
          "1x1": Mesh(("data", "model"), {"data": 1, "model": 1})}


# --------------------------------------------------------------------------
# tests/test_sharding.py on the port's modules
# --------------------------------------------------------------------------


def test_param_rules_basic():
    m = FakeMesh()
    assert param_partition_spec("embed/e", (102400, 5120), m) == \
        ("model", None)
    assert param_partition_spec("blocks/0/attn/wq/w", (5120, 16384), m) \
        == (None, "model")
    assert param_partition_spec("blocks/0/attn/wo/w", (16384, 5120), m) \
        == ("model", None)
    assert param_partition_spec("blocks/0/moe/wi", (160, 5120, 3072), m) \
        == ("model", ("pod", "data"), None)
    assert param_partition_spec("blocks/0/attn/wk/w", (5120, 257), m) \
        == (None, None)


def test_stacked_param_rules():
    m = FakeMesh()
    assert param_partition_spec("blocks_stacked/0/attn/wq/w",
                                (60, 5120, 16384), m) == (None, None, "model")
    assert param_partition_spec("blocks_stacked/0/moe/wi",
                                (60, 160, 5120, 3072), m) \
        == (None, "model", ("pod", "data"), None)


def test_cache_rules():
    m = FakeMesh()
    assert cache_partition_spec("0/k", (128, 32768, 8, 128), m) \
        == (("pod", "data"), "model", None, None)
    assert cache_partition_spec("0/k", (128, 32768, 32, 128), m) \
        == (("pod", "data"), None, "model", None)
    assert cache_partition_spec("0/kv", (60, 128, 32768, 1, 576), m) \
        == (None, ("pod", "data"), "model", None, None)
    assert cache_partition_spec("0/state", (64, 1, 80, 128, 64), m) \
        == (None, None, "model", None, None)
    assert cache_partition_spec("0/len", (60, 128), m) \
        == (None, ("pod", "data"))


def test_make_shardings_cover_every_leaf():
    cfg = t_configs.get("jamba-v0.1-52b").reduced()
    params = stack_params(init_model(cfg, device="cpu"), cfg)
    shard = make_param_shardings(MESHES["1x1"], params)
    assert list(shard) == list(named_leaves(params))
    cache = stack_cache(init_cache(cfg, 2, 16, device="cpu"), cfg)
    cshard = make_cache_shardings(MESHES["1x1"], cache)
    assert [list(c) for c in cshard] == [list(c) for c in cache]


def test_constrain():
    x = torch.ones((4, 4))
    assert constrain(x, (("pod", "data"), None), None) is x
    assert constrain(x, (("pod", "data"), None), MESHES["1x1"]) is x
    with pytest.raises(NotImplementedError, match="R6 a"):
        constrain(x, (("pod", "data"), None), MESHES["16x16"])


def test_elastic_mesh_shapes():
    for n in (512, 256, 384, 16, 48):
        assert elastic.current_mesh_shape(n, 16) == \
            j_elastic.current_mesh_shape(n, 16)
    assert elastic.current_mesh_shape(512, 16) == (2, 16, 16)
    assert elastic.current_mesh_shape(256, 16) == (2, 8, 16)
    assert np.prod(elastic.current_mesh_shape(384, 16)) == 384


def test_straggler_monitor():
    mon, ref = elastic.StragglerMonitor(factor=2.0), \
        j_elastic.StragglerMonitor(factor=2.0)
    for t in (1.0, 1.1, 5.0, 1.2, 0.9, 3.0):
        assert mon.step(t) == ref.step(t)
        assert mon.ewma == ref.ewma and mon.slow_steps == ref.slow_steps
    assert mon.slow_steps == 2


def test_meshes():
    assert make_production_mesh().shape == {"data": 16, "model": 16}
    pod2 = make_production_mesh(multi_pod=True)
    assert pod2.axis_names == ("pod", "data", "model") and pod2.size == 512
    assert pod2.devices is None
    one = make_mesh((1, 1), ("data", "model"), devices=["cpu"])
    assert one.devices == (torch.device("cpu"),) and one.size == 1
    with pytest.raises(ValueError, match="needs 2 devices"):
        make_mesh((1, 2), ("data", "model"), devices=["cpu"])


# --------------------------------------------------------------------------
# every leaf of every assigned config, against the reference's rules
# --------------------------------------------------------------------------


@functools.cache
def _full_leaves(arch_id: str):
    """(param leaves, decode_32k cache leaves) of the full-width config on
    the meta device: (name, shape) pairs."""
    cfg = t_configs.get(arch_id).model
    params = dryrun.abstract_params(cfg)
    p = [(sharding.param_path(k), tuple(t.shape))
         for k, t in named_leaves(params).items()]
    cache = dryrun.abstract_cache(cfg, 128, 32768)
    c = [(f"{i}/{k}", tuple(t.shape)) for i, layer in enumerate(cache)
         for k, t in layer.items()]
    return p, c


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", t_configs.ASSIGNED_ARCHS)
def test_full_width_specs_match_reference(arch, mesh):
    m = MESHES[mesh]
    params, cache = _full_leaves(arch)
    for name, shape in params:
        assert param_partition_spec(name, shape, m) == \
            tuple(j_sharding.param_partition_spec(name, shape, m)), name
    for name, shape in cache:
        assert cache_partition_spec(name, shape, m) == \
            tuple(j_sharding.cache_partition_spec(name, shape, m)), name
    for batch in (1, 8, 128, 256):
        assert sharding.token_sharding(m, batch) == \
            (j_sharding._fit(m, batch, ("pod", "data")), None)


def test_assigned_archs_match_reference():
    assert t_configs.ASSIGNED_ARCHS == j_configs.ASSIGNED_ARCHS


def _key(k) -> str:
    return str(getattr(k, "key", getattr(k, "idx", k)))


def _jax_leaves(tree) -> list:
    return [("/".join(_key(k) for k in path), tuple(leaf.shape))
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.mark.parametrize("arch", t_configs.ASSIGNED_ARCHS)
def test_leaf_names_and_shapes_match_eval_shape(arch):
    """The port's stacked names and shapes (meta device) against
    ``jax.eval_shape`` of the reference's stacked trees, in flatten order,
    on the reduced configs."""
    j_cfg = j_configs.all_archs()[arch].reduced()
    cfg = t_configs.get(arch).reduced()
    j_params = jax.eval_shape(
        lambda k: j_stack_params(j_init_model(k, j_cfg, dtype=jnp.bfloat16),
                                 j_cfg), jax.random.PRNGKey(0))
    params = dryrun.abstract_params(cfg)
    assert [(sharding.param_path(k), tuple(t.shape))
            for k, t in named_leaves(params).items()] == _jax_leaves(j_params)
    assert [str(t.dtype).replace("torch.", "")
            for t in named_leaves(params).values()] == \
        [str(leaf.dtype) for leaf in jax.tree.leaves(j_params)]
    j_cache = jax.eval_shape(lambda: j_stack_cache(
        j_init_cache(j_cfg, 2, 16, dtype=jnp.bfloat16), j_cfg))
    cache = dryrun.abstract_cache(cfg, 2, 16)
    assert [(f"{i}/{k}", tuple(t.shape)) for i, layer in enumerate(cache)
            for k, t in sorted(layer.items())] == _jax_leaves(j_cache)


# --------------------------------------------------------------------------
# the dry run
# --------------------------------------------------------------------------


def _local_bytes(shape, spec, mesh, itemsize) -> int:
    n = 1
    for d, e in zip(shape, tuple(spec) + (None,) * len(shape)):
        axes = () if e is None else (e,) if isinstance(e, str) else e
        n *= -(-d // math.prod(mesh.shape[a] for a in axes))
    return n * itemsize


@pytest.mark.parametrize("multi_pod", [False, True])
def test_whisper_decode_argument_bytes_match_reference_specs(multi_pod):
    """whisper-tiny ``decode_32k``: the dry run's argument bytes equal the
    sum over the reference's own abstract inputs (params, token, cache,
    enc_out) under the reference's specs."""
    arch, shape = j_configs.all_archs()["whisper-tiny"], \
        j_configs.SHAPES["decode_32k"]
    cfg, b, s = arch.model, shape.global_batch, shape.seq_len
    m = make_production_mesh(multi_pod=multi_pod)
    params = jax.eval_shape(
        lambda k: j_stack_params(j_init_model(k, cfg, dtype=jnp.bfloat16),
                                 cfg), jax.random.PRNGKey(0))
    cache = jax.eval_shape(lambda: j_stack_cache(
        j_init_cache(cfg, b, s, dtype=jnp.bfloat16), cfg))
    batch = j_sharding._fit(m, b, ("pod", "data"))
    want = sum(_local_bytes(leaf.shape, j_sharding.param_partition_spec(
        name, leaf.shape, m), m, leaf.dtype.itemsize)
        for name, leaf in ((n, lf) for (n, _), lf in zip(
            _jax_leaves(params), jax.tree.leaves(params))))
    want += sum(_local_bytes(leaf.shape, j_sharding.cache_partition_spec(
        name, leaf.shape, m), m, leaf.dtype.itemsize)
        for (name, _), leaf in zip(_jax_leaves(cache), jax.tree.leaves(cache)))
    want += _local_bytes((b,), P(batch), m, 4)
    want += _local_bytes((b, cfg.encoder_len, cfg.d_model),
                         P(batch, None, None), m, 2)
    rec = dryrun.run_cell(t_configs.get("whisper-tiny"),
                          t_configs.SHAPES["decode_32k"], multi_pod=multi_pod,
                          verbose=False)
    assert rec["argument_bytes_per_device"] == want
    assert rec["n_chips"] == (512 if multi_pod else 256)
    assert rec["flops_per_device"] > 0 and rec["analytic"]
    assert rec["bytes_per_device"] is None and rec["output_bytes_per_device"] \
        is None


def _two_layer_llama():
    return dataclasses.replace(t_configs.get("llama3.2-3b").reduced(),
                               n_layers=2)


def _prefill_hand_count(cfg, b, l) -> int:
    """The products of a ``prefill`` of B x L tokens: the projections, the
    attention (no chunking below 2,048), the FFN and the last position's
    logits."""
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    t = b * l
    mult = 2 if cfg.ffn_gated else 1
    per_layer = (2 * t * d * (hq + 2 * hkv) * hd + 2 * t * hq * hd * d
                 + 4 * b * hq * l * l * hd
                 + 2 * t * d * mult * cfg.d_ff + 2 * t * cfg.d_ff * d)
    return cfg.n_layers * per_layer + 2 * b * d * cfg.vocab


def test_prefill_flops_equal_a_hand_count():
    """FlopCounterMode over a 2-layer reduced llama ``prefill`` on meta."""
    cfg = _two_layer_llama()
    b, l = 2, 16
    params = dryrun.abstract_params(cfg)
    cache = dryrun.abstract_cache(cfg, b, l)
    tokens = torch.zeros((b, l), dtype=torch.int32, device="meta")
    got = dryrun.count_flops(
        lambda: dryrun.prefill_scanned(params, cfg, tokens, cache,
                                       impl="eager", device="meta"))
    assert got == _prefill_hand_count(cfg, b, l)


def test_run_cell_counts_the_cell_it_is_given():
    """``run_cell`` counts the FLOPs of the arch and shape passed in, not
    the registry's cell of the same names: a 2-layer reduced llama's
    ``prefill_32k`` cut to 2 x 16 tokens."""
    arch = dataclasses.replace(t_configs.get("llama3.2-3b"),
                               model=_two_layer_llama())
    shape = dataclasses.replace(t_configs.SHAPES["prefill_32k"], seq_len=16,
                                global_batch=2)
    rec = dryrun.run_cell(arch, shape, verbose=False)
    assert rec["flops_per_device"] * rec["n_chips"] == \
        _prefill_hand_count(arch.model, 2, 16)


def test_train_flops_of_k_microbatches_are_k_times_one():
    """The dry run counts a train step of k microbatches as k times one
    microbatch's step: on a 2-layer reduced llama, B 4 in 2 microbatches
    against the same step counted whole."""
    arch = dataclasses.replace(
        t_configs.get("llama3.2-3b"),
        model=dataclasses.replace(t_configs.get("llama3.2-3b").reduced(),
                                  n_layers=2))
    shape = dataclasses.replace(t_configs.SHAPES["train_4k"], seq_len=8,
                                global_batch=4)
    m = make_production_mesh()

    def count(mb, batch):
        cell = dryrun.build_step(
            arch, dataclasses.replace(shape, global_batch=batch), m,
            dryrun.TrainConfig(microbatches=mb, remat=True))
        return cell.repeats, dryrun.count_flops(lambda: cell.fn(*cell.args))

    (k, whole), (one_k, one) = count(2, 4), count(1, 2)
    assert (k, one_k) == (2, 1) and whole == 2 * one > 0


def test_dryrun_cli_writes_cells_and_roofline_reads_them(tmp_path):
    out = str(tmp_path / "dry")
    dryrun.main(["--arch", "whisper-tiny", "--shape", "decode_32k",
                 "--both-meshes", "--out", out])
    names = sorted(os.listdir(out))
    assert names == ["whisper-tiny__decode_32k__pod1.json",
                     "whisper-tiny__decode_32k__pod2.json",
                     "whisper-tiny__long_500k__skipped.json"]
    rec = json.load(open(os.path.join(out, names[0])))
    assert rec["collective_bytes_per_device"] is None
    recs = roofline.load(out, multi_pod=None)
    done = [r for r in recs if "skipped" not in r]
    assert len(done) == 2 and all(r["t_coll_s"] is None for r in done)
    assert all(r["dominant"] in ("compute", "memory") for r in done)
    assert "| — |" in roofline.to_markdown(recs)
    os.remove(os.path.join(out, names[1]))
    dryrun.main(["--arch", "whisper-tiny", "--shape", "decode_32k",
                 "--both-meshes", "--out", out])     # pod1 cached, pod2 anew
    assert sorted(os.listdir(out)) == names


# --------------------------------------------------------------------------
# the roofline
# --------------------------------------------------------------------------


def _synthetic_records():
    recs = []
    for aid in t_configs.ASSIGNED_ARCHS:
        for sh in t_configs.get(aid).shapes():
            for i, (mp, n) in enumerate(((False, 256), (True, 512))):
                rec = {"arch": aid, "shape": sh.name, "kind": sh.kind,
                       "mesh": "2x16x16" if mp else "16x16",
                       "multi_pod": mp, "n_chips": n,
                       "bytes_per_device": float(10 ** (9 + i)),
                       "collective_bytes_per_device": {
                           "all-reduce": 3e7, "all-gather": 1e6 * (i + 1)},
                       "microbatches": 8 if sh.kind == "train" else 0}
                if i:
                    rec["collective_histogram"] = [
                        ["all-reduce", 4e8, 2], ["all-gather", 2e6, 5]]
                recs.append(rec)
    return recs


TPU = {"PEAK_FLOPS": 197e12, "HBM_BW": 819e9, "NVLINK_LINK_BW": 50e9,
       "NVLINK_LINKS": 4}


def test_roofline_matches_reference_under_tpu_constants(monkeypatch):
    for k, v in TPU.items():
        monkeypatch.setattr(roofline, k, v)
    assert (j_roofline.PEAK_FLOPS, j_roofline.HBM_BW,
            j_roofline.ICI_LINK_BW, j_roofline.ICI_LINKS) == \
        tuple(TPU.values())
    assert roofline.TRAIN_MICROBATCHES == j_roofline.TRAIN_MICROBATCHES
    for rec in _synthetic_records():
        got, want = roofline.analyse(dict(rec)), j_roofline.analyse(dict(rec))
        assert got.keys() == want.keys()
        for k in want:
            if isinstance(want[k], float):
                assert got[k] == pytest.approx(want[k], rel=1e-12), (rec, k)
            else:
                assert got[k] == want[k], (rec, k)
    assert roofline.to_markdown([got]) == j_roofline.to_markdown([want])


def test_roofline_null_fields():
    """No bytes: the analytic floor; no collectives: ``t_coll`` null, the
    dominant term over compute and memory, "—" in the table. The H100's
    constants: 989 TFLOP/s, 3.35 TB/s, 18 x 25 GB/s."""
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.NVLINK_LINK_BW,
            roofline.NVLINK_LINKS) == (989e12, 3.35e12, 25e9, 18)
    base = _synthetic_records()[0]
    rec = dict(base, bytes_per_device=None, collective_bytes_per_device=None)
    r = roofline.analyse(rec)
    assert r["bytes_effective_per_device"] == roofline._bytes_floor(rec)
    assert r["t_coll_s"] is None and r["collective_bytes_scaled"] is None
    assert r["dominant"] == max(("compute", r["t_comp_s"]),
                                ("memory", r["t_mem_s"]),
                                key=lambda kv: kv[1])[0]
    row = roofline.to_markdown([r]).splitlines()[-1]
    assert row.split(" | ")[5] == "—"
    with_coll = roofline.analyse(dict(base, bytes_per_device=None))
    assert with_coll["t_coll_s"] > 0
    assert with_coll["t_mem_s"] == r["t_mem_s"]
    per_step = sum(base["collective_bytes_per_device"].values())
    assert with_coll["collective_bytes_scaled"] == \
        per_step * roofline._layer_trips(base) != per_step


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------

ARGS = ["--reduced", "--steps", "4", "--ckpt-every", "2", "--device", "cpu",
        "--global-batch", "4", "--seq-len", "32"]


def test_launcher_resumes_bit_for_bit(tmp_path, capsys):
    first, resumed = str(tmp_path / "a"), str(tmp_path / "b")
    a = launch_train.main(ARGS + ["--ckpt-dir", first])
    assert a["start"] == 0 and list(a["losses"]) == [0, 1, 2, 3]
    assert all(np.isfinite(v) for v in a["losses"].values())
    os.makedirs(resumed)
    for suffix in ("", ".json"):
        shutil.copy(os.path.join(first, "step_00000002.npz" + suffix),
                    resumed)
    b = launch_train.main(ARGS + ["--ckpt-dir", resumed])
    assert b["start"] == 2 and list(b["losses"]) == [2, 3]
    assert [b["losses"][s] for s in (2, 3)] == [a["losses"][s]
                                                for s in (2, 3)]
    out = capsys.readouterr().out
    assert "[train] mesh {'data': 1, 'model': 1}" in out
    assert "[train] resumed from step 2" in out


_STEP_LINE = re.compile(r"^step +(\d+) loss (\S+) lr (\S+)", re.M)


def _printed_steps(out: str) -> dict:
    return {int(s): (float(loss), lr)
            for s, loss, lr in _STEP_LINE.findall(out)}


def test_launcher_resumes_from_the_reference_launcher(tmp_path, monkeypatch,
                                                      capsys):
    """The JAX launcher's 12 steps (``--ckpt-every 4``) on reduced
    qwen1.5-0.5b on the CPU; the port's launcher resumed from its step-8
    checkpoint, so that it runs the last two warm-up steps and the first
    two of the decay. Steps 8-11: the same learning rate as printed, each
    loss within 1e-5 relative of the reference's (printed to 4 decimals,
    so within 5e-5 more). Step 12's checkpoints: the same leaves, the
    parameters and moments within the 4-step bounds of
    ``tests/test_torch_training.py`` (1e-3 of each leaf's largest |p|,
    at most 1e-4 of the elements past 1e-5). This holds the launcher's
    own choices to the reference's: AdamW at lr 3e-4, warm-up 10 and
    ``total_steps`` = ``--steps``, the data step in ``extra``, the
    restore."""
    from repro.launch import train as j_train

    args = ["--reduced", "--steps", "12", "--ckpt-every", "4",
            "--global-batch", "4", "--seq-len", "32"]
    ref, port = tmp_path / "ref", tmp_path / "port"
    monkeypatch.setattr(sys, "argv", ["train"] + args
                        + ["--ckpt-dir", str(ref)])
    j_train.main()
    want = _printed_steps(capsys.readouterr().out)
    assert sorted(want) == list(range(12))
    os.makedirs(port)
    for suffix in ("", ".json"):
        shutil.copy(ref / ("step_00000008.npz" + suffix), port)
    got = launch_train.main(args + ["--device", "cpu",
                                    "--ckpt-dir", str(port)])
    printed = _printed_steps(capsys.readouterr().out)
    assert got["start"] == 8 and sorted(printed) == [8, 9, 10, 11]
    for s in printed:
        loss, lr = want[s]
        assert printed[s][1] == lr, (s, printed[s], want[s])
        assert abs(got["losses"][s] - loss) <= 5e-5 + 1e-5 * abs(loss), \
            (s, got["losses"][s], loss)
    with np.load(ref / "step_00000012.npz") as w, \
            np.load(port / "step_00000012.npz") as g:
        assert sorted(g.files) == sorted(w.files)
        past = n = 0
        for k in w.files:
            if not k.startswith(("params/", "opt/mu/", "opt/nu/")):
                np.testing.assert_array_equal(g[k], w[k])
                continue
            d = np.abs(g[k].astype(np.float64) - w[k])
            m = np.abs(w[k]).max()
            assert d.max() <= 1e-3 * m, (k, d.max(), m)
            past += int((d > 1e-5 * m).sum())
            n += d.size
        assert past <= 1e-4 * n, (past, n)


def test_launcher_carries_the_compression_residual(tmp_path):
    got = launch_train.main(ARGS[:-4] + ["--global-batch", "4", "--seq-len",
                                         "16", "--compress-grads"])
    assert all(np.isfinite(v) for v in got["losses"].values())


def test_launcher_refuses_more_than_one_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(NotImplementedError, match="R6 a"):
        launch_train.main(["--reduced", "--steps", "1"])
