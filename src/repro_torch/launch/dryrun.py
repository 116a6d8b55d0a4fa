"""Dry run of the port on the meta device: every (architecture x input
shape) cell of the JAX package's ``launch/dryrun.py``, at full width, with
no memory allocated and no card needed.

The reference lowers and compiles each cell on a forced 512-device host
mesh and reads XLA's cost and memory analyses and the partitioned HLO.
torch has no compiler that partitions an eager step over 256 devices, so
the port's dry run is a shape-and-bytes check (ROADMAP R6 c):

* the cell's abstract bfloat16 parameters (stacked, as the reference's),
  optimizer state and caches are built on ``meta``;
* ``argument_bytes_per_device``: every argument tensor's one-device shape
  under the sharding rules (:func:`repro_torch.dist.sharding.shard_shape`)
  on the production mesh, times its item size, summed;
  ``output_bytes_per_device`` likewise where the outputs' specs follow from
  the rules (a train step returns the parameters and the optimizer state;
  the logits of prefill and decode have no rule: null);
* ``flops_per_device``: :class:`torch.utils.flop_counter.FlopCounterMode`
  over one eager step on ``meta`` (forward and backward with remat for
  train), over the mesh's chip count;
* collective bytes are null: the port has no SPMD partitioner, so the
  eager step runs unsharded and issues no collective to count (ROADMAP
  R6 c);
* ``bytes_per_device``, ``temp_bytes_per_device`` and ``code_bytes`` are
  null: no compiler reports them (the roofline then uses its analytic
  bytes floor).

Every number is analytic, not measured. Usage:

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-3b \
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes \
      --out results/dryrun_torch
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
from dataclasses import dataclass, replace

import torch

from ..configs import ASSIGNED_ARCHS, SHAPES, all_archs
from ..configs.base import ArchConfig, Shape
from ..dist.sharding import (
    BATCH_AXES,
    _fit,
    make_cache_shardings,
    make_param_shardings,
    shard_shape,
    token_sharding,
)
from ..models.stacked import stack_cache, stack_params
from ..models.transformer import (
    ModelConfig,
    Transformer,
    decode_step_scanned,
    forward_scanned,
    init_cache,
    prefill_scanned,
)
from ..training.optimizer import adamw_init, adamw_update, named_leaves
from ..training.train_loop import TrainConfig, make_train_step, masked_ce
from .mesh import make_production_mesh

PARAM_DTYPE = torch.bfloat16
META = torch.device("meta")
H100_BYTES = 80e9          # an H100 SXM's HBM3, 80 GB

# ---------------------------------------------------------------------------
# abstract inputs
# ---------------------------------------------------------------------------


# the reference's norm gains and biases stay float32 at any weight dtype
_FLOAT32_NORMS = ("norm1", "norm2", "norm_x", "final_norm", "enc_norm")


def abstract_params(cfg: ModelConfig):
    """The stacked parameters of ``cfg`` on ``meta``, in the reference's
    types (bfloat16, its norms float32): a :class:`Transformer` built
    without a generator (``init_model`` draws on a generator, which the
    meta device has none of), then stacked as the reference's."""
    model = Transformer(cfg, PARAM_DTYPE, META, None)
    for name, mod in model.named_modules():
        if name.rpartition(".")[2] in _FLOAT32_NORMS:
            mod.float()
    return stack_params(model, cfg)


def abstract_opt(params) -> dict:
    return adamw_init(named_leaves(params))


def abstract_cache(cfg: ModelConfig, batch: int, max_len: int) -> list:
    return stack_cache(init_cache(cfg, batch, max_len, dtype=PARAM_DTYPE,
                                  device=META), cfg)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def input_specs(arch: ArchConfig, shape: Shape) -> dict:
    """Meta stand-ins for every model input of this cell."""
    cfg = arch.model
    specs: dict = {}
    if shape.kind == "train":
        specs["tokens"] = _meta((shape.global_batch, shape.seq_len + 1),
                                torch.int32)
    elif shape.kind == "prefill":
        specs["tokens"] = _meta((shape.global_batch, shape.seq_len),
                                torch.int32)
        specs["cache"] = abstract_cache(cfg, shape.global_batch,
                                        shape.seq_len)
    else:  # decode: one new token against a seq_len-deep cache
        specs["token"] = _meta((shape.global_batch,), torch.int32)
        specs["cache"] = abstract_cache(cfg, shape.global_batch,
                                        shape.seq_len)
    if cfg.encoder_layers > 0:
        specs["enc_out"] = _meta(
            (shape.global_batch, cfg.encoder_len, cfg.d_model), PARAM_DTYPE)
    if arch.modality_stub == "vision" and shape.kind == "train":
        # precomputed patch embeddings enter via inputs_embeds
        specs["inputs_embeds"] = _meta(
            (shape.global_batch, shape.seq_len, cfg.d_model), PARAM_DTYPE)
    return specs


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------


@dataclass
class Cell:
    """One cell's step: ``fn(*args)`` runs it on ``meta``; ``arg_leaves``
    and ``out_leaves`` (None where the outputs have no rule) are
    (tensor, spec) pairs of its arguments and outputs; ``microbatches``
    is the train setting the record carries, ``repeats`` how many
    microbatches of one shape the step runs."""

    fn: object
    args: tuple
    arg_leaves: list
    out_leaves: list | None
    microbatches: int = 0
    repeats: int = 1


def _param_leaves(params, mesh, dtype=None) -> list:
    specs = make_param_shardings(mesh, params)
    return [(t if dtype is None else _meta(t.shape, dtype), specs[name])
            for name, t in named_leaves(params).items()]


def _cache_leaves(cache, mesh) -> list:
    return [(t, spec) for layer, specs in
            zip(cache, make_cache_shardings(mesh, cache))
            for t, spec in zip(layer.values(), specs.values())]


def _zero_grads(leaves: dict, got) -> dict:
    return {k: torch.zeros_like(p) if g is None else g
            for (k, p), g in zip(leaves.items(), got)}


def build_step(arch: ArchConfig, shape: Shape, mesh,
               tcfg: TrainConfig | None = None) -> Cell:
    """The cell's step on ``meta`` and its argument and output leaves with
    their specs under the rules on ``mesh``."""
    cfg = arch.model
    specs = input_specs(arch, shape)
    params = abstract_params(cfg)
    p_leaves = _param_leaves(params, mesh)
    batch = _fit(mesh, shape.global_batch, BATCH_AXES)
    tok_spec = token_sharding(mesh, shape.global_batch)
    enc = specs.get("enc_out")
    enc_leaves = [] if enc is None else [(enc, (batch, None, None))]

    if shape.kind == "train":
        from ..tuning import (
            grad_accum_dtype,
            train_compress,
            train_microbatches,
        )
        tcfg = tcfg or TrainConfig(microbatches=train_microbatches(),
                                   remat=True,
                                   compress_grads=train_compress(),
                                   grad_accum_dtype=grad_accum_dtype())
        for t in params.parameters():
            t.requires_grad_(True)
        opt = abstract_opt(params)
        opt_leaves = [(opt[m][k], spec) for m in ("mu", "nu")
                      for k, (_, spec) in zip(opt[m], p_leaves)] \
            + [(opt["step"], ())]
        stats = [(_meta((), torch.float32), ())] * 3   # lr, grad_norm, loss

        def update(params, opt_state, loss):
            leaves = named_leaves(params)
            got = torch.autograd.grad(loss, list(leaves.values()),
                                      allow_unused=True)
            _, opt_state, st = adamw_update(_zero_grads(leaves, got),
                                            opt_state, leaves, tcfg.opt)
            return params, opt_state, dict(st, loss=loss.detach())

        if "inputs_embeds" in specs:
            # VLM: swap token embedding for precomputed patch embeddings
            def step(params, opt_state, embeds):
                logits = forward_scanned(params, cfg, inputs_embeds=embeds,
                                         remat=tcfg.remat, device=META)
                loss = torch.mean(torch.logsumexp(logits.float(), -1))
                return update(params, opt_state, loss)

            emb = specs["inputs_embeds"]
            args = (params, opt, emb)
            arg_leaves = p_leaves + opt_leaves + [(emb, (batch, None, None))]
        elif enc is not None:
            def step(params, opt_state, tokens, enc_out):
                logits = forward_scanned(params, cfg, tokens[:, :-1],
                                         enc_out=enc_out, remat=tcfg.remat,
                                         device=META)
                return update(params, opt_state,
                              masked_ce(logits.float(), tokens[:, 1:]))

            args = (params, opt, specs["tokens"], enc)
            arg_leaves = p_leaves + opt_leaves \
                + [(specs["tokens"], tok_spec)] + enc_leaves
        else:
            step = make_train_step(cfg, tcfg)
            args = (params, opt, specs["tokens"])
            arg_leaves = p_leaves + opt_leaves \
                + [(specs["tokens"], tok_spec)]
            if tcfg.compress_grads:
                residual = {name: _meta(t.shape, torch.float32)
                            for name, t in named_leaves(params).items()}
                args = args + (residual,)
                res_leaves = _param_leaves(params, mesh, torch.float32)
                arg_leaves = arg_leaves + res_leaves
                stats = stats + res_leaves
            return Cell(step, args, arg_leaves,
                        p_leaves + opt_leaves + stats, tcfg.microbatches,
                        repeats=tcfg.microbatches)
        return Cell(step, args, arg_leaves, p_leaves + opt_leaves + stats,
                    tcfg.microbatches)

    cache = specs["cache"]
    if shape.kind == "prefill":
        def step(params, tokens, cache, enc_out=None):
            return prefill_scanned(params, cfg, tokens, cache, impl="eager",
                                   device=META, enc_out=enc_out)

        first = (specs["tokens"], tok_spec)
    else:
        # decode / serve_step
        def step(params, token, cache, enc_out=None):
            return decode_step_scanned(params, cfg, token, cache,
                                       impl="eager", device=META,
                                       enc_out=enc_out)

        first = (specs["token"], (batch,))
    args = (params, first[0], cache) + (() if enc is None else (enc,))
    return Cell(step, args,
                p_leaves + [first] + _cache_leaves(cache, mesh) + enc_leaves,
                None)


def leaf_bytes(leaves, mesh) -> int:
    """Bytes one device holds of (tensor, spec) pairs under the rules."""
    return sum(math.prod(shard_shape(t.shape, spec, mesh)) * t.element_size()
               for t, spec in leaves)


# ---------------------------------------------------------------------------
# counted FLOPs
# ---------------------------------------------------------------------------


def count_flops(fn) -> int:
    """The FLOPs :class:`~torch.utils.flop_counter.FlopCounterMode` counts
    over ``fn()``: 2 per multiply-add of every product (matmul, bmm,
    einsum's products, convolution, attention), forward and backward."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        fn()
    return int(counter.get_total_flops())


def step_flops(arch: ArchConfig, shape: Shape, cell: Cell) -> int:
    """FLOPs of one eager step of ``cell``, the cell of ``arch`` x
    ``shape``, on ``meta``. A train step of k microbatches of one shape is
    counted as k times a step of one microbatch of B / k rows: the counter
    counts only products, and the gradient sums and the optimizer are
    elementwise, so the two counts are equal (tested), and the trace is k
    times shorter."""
    k = cell.repeats
    if k > 1:
        from ..tuning import grad_accum_dtype, train_compress

        cell = build_step(
            arch, replace(shape, global_batch=shape.global_batch // k),
            make_production_mesh(),
            TrainConfig(microbatches=1, remat=True,
                        compress_grads=train_compress(),
                        grad_accum_dtype=grad_accum_dtype()))
    return k * count_flops(lambda: cell.fn(*cell.args))


# ---------------------------------------------------------------------------
# the dry run itself
# ---------------------------------------------------------------------------


def run_cell(arch: ArchConfig, shape: Shape, multi_pod: bool = False,
             verbose: bool = True) -> dict:
    mesh = make_production_mesh(multi_pod=multi_pod)
    t0 = time.time()
    cell = build_step(arch, shape, mesh)
    flops = step_flops(arch, shape, cell)
    n_chips = mesh.size
    rec = {
        "arch": arch.arch_id,
        "shape": shape.name,
        "kind": shape.kind,
        "mesh": "x".join(str(mesh.shape[a]) for a in mesh.axis_names),
        "multi_pod": multi_pod,
        "n_chips": n_chips,
        "flops_per_device": flops / n_chips,
        "bytes_per_device": None,
        "collective_bytes_per_device": None,
        "collective_histogram": None,
        "argument_bytes_per_device": leaf_bytes(cell.arg_leaves, mesh),
        "output_bytes_per_device": (None if cell.out_leaves is None
                                    else leaf_bytes(cell.out_leaves, mesh)),
        "temp_bytes_per_device": None,
        "code_bytes": None,
        "microbatches": cell.microbatches,
        "analytic": True,
        "trace_s": round(time.time() - t0, 1),
    }
    if verbose:
        gib = rec["argument_bytes_per_device"] / 2**30
        print(f"[dryrun] {arch.arch_id:>20s} x {shape.name:<12s} mesh "
              f"{rec['mesh']:>8s}: OK  args={gib:.2f} GiB/dev "
              f"(H100: {H100_BYTES / 2**30:.2f} GiB)  "
              f"flops/dev={rec['flops_per_device']:.3e}  "
              f"(trace {rec['trace_s']:.0f}s)")
    return rec


def cells_for(arch: ArchConfig) -> list[Shape]:
    return arch.shapes()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", type=str, default="results/dryrun")
    args = ap.parse_args(argv)

    archs = all_archs()
    todo: list[tuple[ArchConfig, Shape, bool]] = []
    arch_ids = ASSIGNED_ARCHS if (args.all or args.arch is None) \
        else [args.arch]
    for aid in arch_ids:
        arch = archs[aid]
        shapes = cells_for(arch) if args.shape is None \
            else [SHAPES[args.shape]]
        for sh in shapes:
            if args.both_meshes:
                todo.append((arch, sh, False))
                todo.append((arch, sh, True))
            else:
                todo.append((arch, sh, args.multi_pod))

    os.makedirs(args.out, exist_ok=True)
    failures = []
    for arch, sh, mp in todo:
        tag = f"{arch.arch_id}__{sh.name}__{'pod2' if mp else 'pod1'}"
        path = os.path.join(args.out, tag + ".json")
        if os.path.exists(path):
            print(f"[dryrun] skip cached {tag}")
            continue
        try:
            rec = run_cell(arch, sh, multi_pod=mp)
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
        except Exception as e:  # a failure here is a bug in the port
            failures.append((tag, repr(e)))
            print(f"[dryrun] FAIL {tag}: {e!r}")
    # skipped cells are recorded so the roofline table is complete
    for aid in arch_ids:
        arch = archs[aid]
        for sh, why in arch.skipped_shapes():
            tag = f"{arch.arch_id}__{sh.name}__skipped"
            with open(os.path.join(args.out, tag + ".json"), "w") as f:
                json.dump({"arch": arch.arch_id, "shape": sh.name,
                           "skipped": why}, f, indent=1)
    if failures:
        raise SystemExit(f"{len(failures)} dry-run failures: {failures}")
    print("[dryrun] all cells OK")


if __name__ == "__main__":
    main()
