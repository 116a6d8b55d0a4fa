"""Roofline analysis from the dry-run records, ported line for line from
the JAX package's ``launch/roofline.py`` with an H100's rates in place of
the TPU's.

Per (arch x shape x mesh) cell, three terms:

    t_comp = FLOPs_per_device / peak_flops          (989 TFLOP/s bf16)
    t_mem  = bytes_per_device / hbm_bw              (3.35 TB/s)
    t_coll = collective_bytes_per_device / link_bw  (25 GB/s/link x 18 links)

The FLOPs are analytic, from the DSE workload graph (exact per-op GEMM
counts, including attention's quadratic term, MoE activation, SSD): x3 for
train (fwd + bwd). The bytes are the record's, or, where the record has
none (the port's dry run has no compiler to report them), the analytic
floor: parameter traffic (weights re-read per microbatch; optimizer
moments r/w for train) + KV/state cache traffic + residual-stream
activations. Collective bytes come from the record and are scaled by the
layer-loop trip product (the reference's HLO holds a scanned body once);
a record without them (the port's dry run: ROADMAP R6 c) gets no
``t_coll`` (null, "—" in the table), and its ``dominant`` term is taken
over compute and memory.

The production meshes' 16-wide model axis spans two 8-GPU NVLink domains,
so a collective over it crosses the slower inter-node network: ``t_coll``
at the NVLink rate is a lower bound.

MODEL_FLOPS = 6*N_active*tokens (train) / 2*N_active*tokens (inference);
the ratio MODEL_FLOPS/FLOPs exposes attention-quadratic, remat and MoE
dispatch overheads.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from functools import lru_cache

PEAK_FLOPS = 989e12      # H100 SXM, dense bfloat16 tensor-core FLOP/s
HBM_BW = 3.35e12         # H100 SXM HBM3, bytes/s
NVLINK_LINK_BW = 25e9    # NVLink 4, bytes/s per link and direction
NVLINK_LINKS = 18        # NVLink 4 links per H100 SXM
TRAIN_MICROBATCHES = 8   # matches launch/dryrun.py's default TrainConfig


@lru_cache(maxsize=None)
def _arch(arch_id: str):
    from ..configs import all_archs

    return all_archs()[arch_id]


@lru_cache(maxsize=None)
def _workload_graph_flops(arch_id: str, shape_name: str) -> float:
    """Exact forward FLOPs of one step from the DSE workload graph."""
    from ..configs import SHAPES
    from ..core.workload import (
        build_execution_graph,
        decode_request,
        prefill_request,
    )

    arch = _arch(arch_id)
    spec = arch.llm_spec()
    shape = SHAPES[shape_name]
    if shape.kind == "decode":
        batch = [decode_request(shape.seq_len)] * shape.global_batch
    else:
        batch = [prefill_request(shape.seq_len)] * shape.global_batch
    g = build_execution_graph(spec, batch, micro_batch_size=len(batch),
                              tp=1, n_blocks=None)
    flops = g.total_flops()
    if shape.kind == "train":
        flops *= 3.0  # fwd + 2x bwd
        # + vocab projection (graph covers blocks only)
        flops += 6.0 * shape.global_batch * shape.seq_len \
            * spec.d_model * spec.vocab
    else:
        flops += 2.0 * (shape.global_batch if shape.kind == "decode"
                        else shape.global_batch * shape.seq_len) \
            * spec.d_model * spec.vocab
    return flops


def _bytes_floor(rec: dict) -> float:
    """Analytic HBM-traffic floor per device (bytes)."""
    from ..configs import SHAPES

    arch = _arch(rec["arch"])
    spec = arch.llm_spec()
    shape = SHAPES[rec["shape"]]
    n = rec["n_chips"]
    params = spec.param_count()
    active = spec.active_param_count()
    kv_bytes = (spec.kv_elems_per_token * 2
                * sum(1 for i in range(spec.n_layers)
                      if spec.mixer_kind(i) == "attn"))
    tokens = shape.global_batch * shape.seq_len
    act_stream = 2.0 * spec.d_model * spec.n_layers * 2  # residual r/w bf16

    if shape.kind == "train":
        mb = rec.get("microbatches") or TRAIN_MICROBATCHES
        # weights re-read per microbatch (fwd+bwd) + grads f32 + AdamW
        # moments read+write f32 + bf16 param write
        traffic = (params * 2 * 2 * mb                   # bf16 fwd+bwd reads
                   + params * (4 + 16 + 2)               # grad + moments + w
                   + tokens * act_stream * 2)            # remat: 2 passes
    elif shape.kind == "prefill":
        traffic = (params * 2 + tokens * kv_bytes        # cache write
                   + tokens * act_stream)
    else:  # decode: one token per sequence against the full cache
        ctx_tokens = shape.global_batch * shape.seq_len
        traffic = (active * 2 + ctx_tokens * kv_bytes    # cache read
                   + shape.global_batch * act_stream)
    return traffic / n


def _layer_trips(rec: dict) -> float:
    from ..models.stacked import layer_period

    arch = _arch(rec["arch"])
    cfg = arch.model
    trips = cfg.n_layers / layer_period(cfg)
    if rec["kind"] == "train":
        trips *= rec.get("microbatches") or TRAIN_MICROBATCHES
    return trips


def model_flops_per_device(rec: dict) -> float:
    """6*N*D (train) or 2*N*D (inference) over the mesh."""
    from ..configs import SHAPES

    shape = SHAPES[rec["shape"]]
    n_active = _arch(rec["arch"]).llm_spec().active_param_count()
    if rec["kind"] == "train":
        total = 6.0 * n_active * shape.global_batch * shape.seq_len
    elif rec["kind"] == "prefill":
        total = 2.0 * n_active * shape.global_batch * shape.seq_len
    else:
        total = 2.0 * n_active * shape.global_batch
    return total / rec["n_chips"]


def _coll_bytes(rec: dict) -> float | None:
    """Scaled collective traffic: per-layer collectives (activation-sized,
    inside the scanned bodies) multiply by the loop trip product; param-sized
    step-level collectives (e.g. the gradient all-reduce) count once. None
    when the record has no collective bytes."""
    trips = _layer_trips(rec)
    hist = rec.get("collective_histogram")
    if not hist:
        per_kind = rec.get("collective_bytes_per_device")
        if per_kind is None:
            return None
        return sum(per_kind.values()) * trips
    total = 0.0
    for _kind, nbytes, count in hist:
        step_level = rec["kind"] == "train" and nbytes > 1e8
        total += nbytes * count * (1.0 if step_level else trips)
    return total


def analyse(rec: dict) -> dict:
    flops_dev = _workload_graph_flops(rec["arch"], rec["shape"]) / rec["n_chips"]
    t_comp = flops_dev / PEAK_FLOPS
    floor = _bytes_floor(rec)
    bytes_dev = floor if rec.get("bytes_per_device") is None \
        else max(rec["bytes_per_device"], floor)
    t_mem = bytes_dev / HBM_BW
    coll = _coll_bytes(rec)
    t_coll = None if coll is None else coll / (NVLINK_LINK_BW * NVLINK_LINKS)
    terms = {"compute": t_comp, "memory": t_mem}
    if t_coll is not None:
        terms["collective"] = t_coll
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    mf = model_flops_per_device(rec)
    useful = mf / flops_dev if flops_dev else 0.0
    frac = (mf / PEAK_FLOPS) / bound if bound > 0 else 0.0
    return dict(
        rec,
        flops_analytic_per_device=flops_dev,
        bytes_effective_per_device=bytes_dev,
        collective_bytes_scaled=coll,
        t_comp_s=t_comp,
        t_mem_s=t_mem,
        t_coll_s=t_coll,
        dominant=dominant,
        model_flops_per_device=mf,
        useful_flops_ratio=useful,
        roofline_fraction=frac,
    )


def load(dir_: str, multi_pod: bool | None = False) -> list[dict]:
    recs = []
    for path in sorted(glob.glob(os.path.join(dir_, "*.json"))):
        with open(path) as f:
            r = json.load(f)
        if "skipped" in r:
            recs.append(r)
            continue
        if multi_pod is not None and r.get("multi_pod") != multi_pod:
            continue
        recs.append(analyse(r))
    return recs


def _ms(t) -> str:
    return "—" if t is None else f"{t*1e3:.2f}"


def to_markdown(recs: list[dict]) -> str:
    hdr = ("| arch | shape | mesh | t_comp (ms) | t_mem (ms) | t_coll (ms) | "
           "dominant | MODEL/FLOPs | roofline frac |\n"
           "|---|---|---|---|---|---|---|---|---|\n")
    rows = []
    for r in recs:
        if "skipped" in r:
            rows.append(f"| {r['arch']} | {r['shape']} | — | — | — | — | "
                        f"skipped | — | — |")
            continue
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {_ms(r['t_comp_s'])} | {_ms(r['t_mem_s'])} "
            f"| {_ms(r['t_coll_s'])} | {r['dominant']} "
            f"| {r['useful_flops_ratio']:.2f} | {r['roofline_fraction']:.3f} |")
    return hdr + "\n".join(rows)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/dryrun")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--md", action="store_true")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    recs = load(args.dir, multi_pod=args.multi_pod)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(recs, f, indent=1)
    if args.md:
        print(to_markdown(recs))
    else:
        for r in recs:
            if "skipped" in r:
                print(f"{r['arch']:>20s} {r['shape']:<12s} SKIPPED: {r['skipped']}")
                continue
            coll = "—" if r["t_coll_s"] is None \
                else f"{r['t_coll_s']*1e3:8.2f}ms"
            print(f"{r['arch']:>20s} {r['shape']:<12s} {r['mesh']:>8s} "
                  f"comp={r['t_comp_s']*1e3:8.2f}ms mem={r['t_mem_s']*1e3:8.2f}ms "
                  f"coll={coll} -> {r['dominant']:<10s} "
                  f"model/flops={r['useful_flops_ratio']:.2f} "
                  f"frac={r['roofline_fraction']:.3f}")


if __name__ == "__main__":
    main()
