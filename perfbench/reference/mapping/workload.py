"""Frozen copy of the port's ``core/workload.py`` (pure Python and numpy), kept
beside the benchmark so that the reference rebuilds what the port derives
(rollouts, execution graphs, cost tables) with code that later changes to
the port cannot move. The original docstring follows.

LLM serving workloads as computation execution graphs (paper §III-A, §IV).

A serving *batch* is a list of requests that differ in kind (prefill /
decode) and sequence length. One engine iteration processes, per request,
``q_len`` new tokens against a ``kv_len``-token context. The workload is a
2-D computation execution graph: rows = micro-batches (groups of
``micro_batch_size`` requests), columns = layers. Merged layers (QKV
generation, projections, FFN) fuse all requests of the micro-batch into one
GEMM over the summed token count; split layers (attention, SSD scan) cost the
per-request sum — the merge/split/re-merge pattern of the paper's Fig. 2.

Tensor parallelism enters as layer partitioning (paper §IV last paragraph):
FFN1/FFN2 are split into ``tp`` column/row slices, each an independently
mappable column of the graph, with an explicit fan-in reduce op.

Dependencies are contiguous *column intervals* per layer (chain, TP fan-out/
fan-in, MoE routing), which keeps the evaluator vectorisable.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

PREFILL = "prefill"
DECODE = "decode"


@dataclass(frozen=True)
class Request:
    kind: str     # prefill | decode
    q_len: int    # new tokens processed this iteration (decode: 1; chunked prefill: chunk)
    kv_len: int   # total context length attended over (>= q_len for prefill chunks)

    def __post_init__(self):
        assert self.kind in (PREFILL, DECODE)
        # q_len >= 1 for BOTH kinds; kv_len >= q_len only required for
        # prefill (a decode snapshot may attend a context shorter than its
        # recorded kv_len bookkeeping would suggest).
        assert self.q_len >= 1 and (self.kv_len >= self.q_len
                                    or self.kind == DECODE)


def prefill_request(seq_len: int, prior_context: int = 0) -> Request:
    return Request(PREFILL, seq_len, seq_len + prior_context)


def decode_request(context_len: int) -> Request:
    return Request(DECODE, 1, context_len)


@dataclass(frozen=True)
class MoESpec:
    n_routed: int
    n_shared: int
    top_k: int
    d_expert: int


@dataclass(frozen=True)
class LLMSpec:
    """Architecture description at the granularity the DSE engine needs."""

    name: str
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    n_layers: int
    ffn_gated: bool = True
    attn_kind: str = "gqa"        # mha | gqa | mla | none
    mla_kv_rank: int = 0
    mla_rope_dim: int = 64
    moe: MoESpec | None = None
    moe_every: int = 1            # MoE FFN on layers with idx % moe_every == moe_every-1
    mixer: str = "attn"           # attn | mamba | hybrid
    attn_every: int = 8           # hybrid: attention on layers with idx % attn_every == 0
    d_inner: int = 0              # mamba expanded dim
    ssm_state: int = 0
    cross_attention: bool = False  # enc-dec decoder blocks (whisper)
    cross_len: int = 1500          # encoder output length for cross-attention

    def mixer_kind(self, layer_idx: int) -> str:
        if self.mixer == "attn":
            return "attn"
        if self.mixer == "mamba":
            return "mamba"
        return "attn" if layer_idx % self.attn_every == self.attn_every // 2 else "mamba"

    def ffn_kind(self, layer_idx: int) -> str:
        if self.moe is not None and layer_idx % self.moe_every == self.moe_every - 1:
            return "moe"
        return "dense" if self.d_ff > 0 else "none"

    @property
    def kv_elems_per_token(self) -> int:
        if self.attn_kind == "mla":
            return self.mla_kv_rank + self.mla_rope_dim
        if self.attn_kind == "none":
            return 0
        return 2 * self.n_kv_heads * self.head_dim

    def param_count(self) -> float:
        """Total parameters (for MODEL_FLOPS and sanity checks)."""
        d = self.d_model
        per_layer = 0.0
        for i in range(self.n_layers):
            if self.mixer_kind(i) == "attn":
                if self.attn_kind == "mla":
                    per_layer += d * (self.n_heads * self.head_dim + self.mla_kv_rank
                                      + self.mla_rope_dim)
                    per_layer += (self.mla_kv_rank
                                  * self.n_heads * self.head_dim * 2)  # up-projections
                else:
                    per_layer += d * (self.n_heads + 2 * self.n_kv_heads) * self.head_dim
                per_layer += self.n_heads * self.head_dim * d  # out proj
            else:
                di = self.d_inner
                per_layer += d * (2 * di + 2 * self.ssm_state) + di * d
            if self.ffn_kind(i) == "none":
                pass
            elif self.ffn_kind(i) == "dense":
                mult = 3 if self.ffn_gated else 2
                per_layer += mult * d * self.d_ff
            else:
                moe = self.moe
                mult = 3 if self.ffn_gated else 2
                per_layer += d * moe.n_routed  # router
                per_layer += mult * d * moe.d_expert * (moe.n_routed + moe.n_shared)
        return per_layer + 2 * d * self.vocab  # embed + head

    def active_param_count(self) -> float:
        """Activated parameters per token (MoE: top-k + shared only)."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        total = 2 * d * self.vocab
        for i in range(self.n_layers):
            if self.mixer_kind(i) == "attn":
                if self.attn_kind == "mla":
                    total += d * (self.n_heads * self.head_dim + self.mla_kv_rank
                                  + self.mla_rope_dim)
                    total += self.mla_kv_rank * self.n_heads * self.head_dim * 2
                else:
                    total += d * (self.n_heads + 2 * self.n_kv_heads) * self.head_dim
                total += self.n_heads * self.head_dim * d
            else:
                di = self.d_inner
                total += d * (2 * di + 2 * self.ssm_state) + di * d
            if self.ffn_kind(i) == "none":
                pass
            elif self.ffn_kind(i) == "dense":
                total += (3 if self.ffn_gated else 2) * d * self.d_ff
            else:
                moe = self.moe
                total += d * moe.n_routed
                total += ((3 if self.ffn_gated else 2) * d * moe.d_expert
                          * (moe.top_k + moe.n_shared))
        return total


# --------------------------------------------------------------------------
# Graph structures
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class GemmShape:
    m: int
    k: int
    n: int
    count: int = 1

    @property
    def flops(self) -> float:
        return 2.0 * self.m * self.k * self.n * self.count


@dataclass
class OpSpec:
    """One node (row, col) of the execution graph."""

    name: str
    gemms: tuple[GemmShape, ...] = ()
    post_flops: float = 0.0
    weight_elems: int = 0        # elidable weights (Algorithm 2 isLoadWei)
    stream_elems: int = 0        # mandatory DRAM reads (KV cache / SSM state)
    extra_write_elems: int = 0   # mandatory DRAM writes (KV persist / state)
    out_elems: int = 0           # activation output
    dataflow_neutral: bool = False

    @property
    def flops(self) -> float:
        return sum(g.flops for g in self.gemms) + self.post_flops


@dataclass(frozen=True)
class LayerMeta:
    """Per-column metadata (identical across rows)."""

    name: str
    pred_lo: int   # predecessor column interval [pred_lo, pred_hi); -1,-1 = none
    pred_hi: int
    weight_id: int  # columns sharing weights across rows share an id (== col)


@dataclass
class ExecutionGraph:
    spec: LLMSpec
    layers: list[LayerMeta]            # length M
    ops: list[list[OpSpec]]            # [rows][M]
    requests_per_row: list[list[Request]]
    scale: float                       # n_layers / blocks evaluated

    @property
    def rows(self) -> int:
        return len(self.ops)

    @property
    def n_cols(self) -> int:
        return len(self.layers)

    def total_flops(self) -> float:
        return self.scale * sum(op.flops for row in self.ops for op in row)


# --------------------------------------------------------------------------
# Graph construction
# --------------------------------------------------------------------------


def representative_blocks(spec: LLMSpec, max_blocks: int = 8) -> int:
    """Smallest window of consecutive blocks covering the layer pattern."""
    period = 1
    if spec.mixer == "hybrid":
        period = spec.attn_every
    if spec.moe is not None:
        period = max(period, spec.moe_every)
    return min(max(period, 1), max_blocks, spec.n_layers)


def build_execution_graph(
    spec: LLMSpec,
    batch: Sequence[Request],
    micro_batch_size: int,
    tp: int = 8,
    n_blocks: int | None = None,
    moe_groups: int | None = None,
) -> ExecutionGraph:
    if n_blocks is None:
        n_blocks = representative_blocks(spec)
    n_blocks = min(n_blocks, spec.n_layers)
    m = max(1, min(micro_batch_size, len(batch)))
    rows_req: list[list[Request]] = [
        list(batch[i: i + m]) for i in range(0, len(batch), m)
    ]

    layers: list[LayerMeta] = []
    per_row_ops: list[Callable[[list[Request]], OpSpec]] = []

    def add(name: str, pred_lo: int, pred_hi: int,
            build: Callable[[list[Request]], OpSpec]) -> int:
        col = len(layers)
        layers.append(LayerMeta(name, pred_lo, pred_hi, weight_id=col))
        per_row_ops.append(build)
        return col

    d = spec.d_model
    h, kvh, hd = spec.n_heads, spec.n_kv_heads, spec.head_dim

    def sum_q(reqs):
        return sum(r.q_len for r in reqs)

    def _mk_attn_block(li: int, prev: int) -> int:
        if spec.attn_kind == "mla":
            qkv_n = h * hd + spec.mla_kv_rank + spec.mla_rope_dim
            dh_qk = spec.mla_kv_rank + spec.mla_rope_dim
            dh_v = spec.mla_kv_rank
        else:
            qkv_n = (h + 2 * kvh) * hd
            dh_qk = hd
            dh_v = hd
        kv_tok = spec.kv_elems_per_token

        def mk_qkv(reqs, qkv_n=qkv_n):
            sq = sum_q(reqs)
            return OpSpec(
                "qkv", (GemmShape(sq, d, qkv_n),),
                post_flops=4.0 * sq * d,  # pre-norm + rope
                weight_elems=d * qkv_n,
                out_elems=sq * qkv_n,
            )

        c_qkv = add(f"b{li}.qkv", prev, prev + 1 if prev >= 0 else -1, mk_qkv)

        def mk_attn(reqs, dh_qk=dh_qk, dh_v=dh_v, kv_tok=kv_tok):
            gemms, post, stream, wr = [], 0.0, 0, 0
            for r in reqs:
                gemms.append(GemmShape(r.q_len, dh_qk, r.kv_len, count=h))
                gemms.append(GemmShape(r.q_len, r.kv_len, dh_v, count=h))
                post += 5.0 * r.q_len * r.kv_len * h
                # KV cache: persist new tokens; stream prior context
                wr += r.q_len * kv_tok
                stream += max(0, r.kv_len - r.q_len) * kv_tok
            return OpSpec(
                "attn", tuple(gemms), post_flops=post,
                stream_elems=stream, extra_write_elems=wr,
                out_elems=sum_q(reqs) * h * dh_v, dataflow_neutral=True,
            )

        c_attn = add(f"b{li}.attn", c_qkv, c_qkv + 1, mk_attn)

        def mk_proj(reqs, dh_v=dh_v):
            sq = sum_q(reqs)
            return OpSpec(
                "proj", (GemmShape(sq, h * dh_v, d),),
                post_flops=4.0 * sq * d,  # residual + norm
                weight_elems=h * dh_v * d,
                out_elems=sq * d,
            )

        return add(f"b{li}.proj", c_attn, c_attn + 1, mk_proj)

    def _mk_cross_attn_block(li: int, prev: int) -> int:
        def mk_q(reqs):
            sq = sum_q(reqs)
            return OpSpec(
                "q_cross", (GemmShape(sq, d, h * hd),),
                post_flops=2.0 * sq * d,
                weight_elems=d * h * hd, out_elems=sq * h * hd,
            )

        c_q = add(f"b{li}.q_cross", prev, prev + 1 if prev >= 0 else -1, mk_q)

        def mk_xattn(reqs):
            gemms, post, stream = [], 0.0, 0
            for r in reqs:
                gemms.append(GemmShape(r.q_len, hd, spec.cross_len, count=h))
                gemms.append(GemmShape(r.q_len, spec.cross_len, hd, count=h))
                post += 5.0 * r.q_len * spec.cross_len * h
                stream += spec.cross_len * 2 * kvh * hd  # encoder KV from DRAM
            return OpSpec(
                "attn_cross", tuple(gemms), post_flops=post,
                stream_elems=stream, out_elems=sum_q(reqs) * h * hd,
                dataflow_neutral=True,
            )

        c_x = add(f"b{li}.attn_cross", c_q, c_q + 1, mk_xattn)

        def mk_proj(reqs):
            sq = sum_q(reqs)
            return OpSpec(
                "proj_cross", (GemmShape(sq, h * hd, d),),
                post_flops=4.0 * sq * d,
                weight_elems=h * hd * d, out_elems=sq * d,
            )

        return add(f"b{li}.proj_cross", c_x, c_x + 1, mk_proj)

    def _mk_mamba_block(li: int, prev: int) -> int:
        di, st = spec.d_inner, spec.ssm_state
        in_n = 2 * di + 2 * st

        def mk_in(reqs, in_n=in_n):
            sq = sum_q(reqs)
            return OpSpec(
                "in_proj", (GemmShape(sq, d, in_n),),
                post_flops=3.0 * sq * d,
                weight_elems=d * in_n, out_elems=sq * in_n,
            )

        c_in = add(f"b{li}.in_proj", prev, prev + 1 if prev >= 0 else -1, mk_in)

        def mk_ssd(reqs, di=di, st=st):
            gemms, post, stream, wr = [], 0.0, 0, 0
            for r in reqs:
                # SSD chunked form: state update + output contraction
                gemms.append(GemmShape(r.q_len, st, di))
                gemms.append(GemmShape(r.q_len, di, st))
                post += 6.0 * r.q_len * di
                stream += di * st       # recurrent state read
                wr += di * st           # recurrent state write-back
            return OpSpec(
                "ssd", tuple(gemms), post_flops=post,
                stream_elems=stream, extra_write_elems=wr,
                out_elems=sum_q(reqs) * di, dataflow_neutral=True,
            )

        c_ssd = add(f"b{li}.ssd", c_in, c_in + 1, mk_ssd)

        def mk_out(reqs, di=di):
            sq = sum_q(reqs)
            return OpSpec(
                "out_proj", (GemmShape(sq, di, d),),
                post_flops=4.0 * sq * d,
                weight_elems=di * d, out_elems=sq * d,
            )

        return add(f"b{li}.out_proj", c_ssd, c_ssd + 1, mk_out)

    def _mk_dense_ffn(li: int, prev: int) -> int:
        mult = 2 if spec.ffn_gated else 1
        up_n = _ceil_div(mult * spec.d_ff, tp)
        dn_k = _ceil_div(spec.d_ff, tp)
        first_up = len(layers)
        for i in range(tp):
            def mk_up(reqs, up_n=up_n):
                sq = sum_q(reqs)
                return OpSpec(
                    "ffn1", (GemmShape(sq, d, up_n),),
                    post_flops=2.0 * sq * up_n,  # activation (+ gate mult)
                    weight_elems=d * up_n, out_elems=sq * _ceil_div(spec.d_ff, tp),
                )
            add(f"b{li}.ffn1_{i}", prev, prev + 1, mk_up)
        first_dn = len(layers)
        for i in range(tp):
            def mk_dn(reqs, dn_k=dn_k):
                sq = sum_q(reqs)
                return OpSpec(
                    "ffn2", (GemmShape(sq, dn_k, d),),
                    weight_elems=dn_k * d, out_elems=sq * d,
                )
            add(f"b{li}.ffn2_{i}", first_up + i, first_up + i + 1, mk_dn)

        def mk_red(reqs):
            sq = sum_q(reqs)
            return OpSpec(
                "reduce", post_flops=float(tp * sq * d + 2 * sq * d),
                out_elems=sq * d, dataflow_neutral=True,
            )

        return add(f"b{li}.reduce", first_dn, first_dn + tp, mk_red)

    def _mk_moe_ffn(li: int, prev: int) -> int:
        moe = spec.moe
        groups = moe_groups if moe_groups is not None else min(tp, moe.n_routed)
        groups = max(1, min(groups, moe.n_routed))
        epg = _ceil_div(moe.n_routed, groups)
        mult = 3 if spec.ffn_gated else 2

        def mk_router(reqs, moe=moe):
            sq = sum_q(reqs)
            return OpSpec(
                "router", (GemmShape(sq, d, moe.n_routed),),
                post_flops=3.0 * sq * moe.n_routed,
                weight_elems=d * moe.n_routed, out_elems=sq * d,
            )

        c_router = add(f"b{li}.router", prev, prev + 1, mk_router)

        c_shared = -1
        if moe.n_shared > 0:
            def mk_shared(reqs, moe=moe, mult=mult):
                sq = sum_q(reqs)
                up_n = (mult - 1) * moe.d_expert * moe.n_shared
                return OpSpec(
                    "shared_ffn",
                    (GemmShape(sq, d, up_n),
                     GemmShape(sq, moe.d_expert * moe.n_shared, d)),
                    post_flops=2.0 * sq * up_n,
                    weight_elems=d * up_n + moe.d_expert * moe.n_shared * d,
                    out_elems=sq * d,
                )
            c_shared = add(f"b{li}.shared", prev, prev + 1, mk_shared)

        first_g = len(layers)
        for g in range(groups):
            def mk_group(reqs, moe=moe, epg=epg, mult=mult):
                sq = sum_q(reqs)
                # routed tokens spread across the group's experts
                m_e = max(1, _ceil_div(sq * moe.top_k, moe.n_routed))
                up_n = (mult - 1) * moe.d_expert
                return OpSpec(
                    "moe_group",
                    (GemmShape(m_e, d, up_n, count=epg),
                     GemmShape(m_e, moe.d_expert, d, count=epg)),
                    post_flops=2.0 * m_e * up_n * epg,
                    weight_elems=epg * (d * up_n + moe.d_expert * d),
                    out_elems=sq * d,  # after combine weighting
                )
            # interval [prev, c_router+1) covers the mixer output + router
            add(f"b{li}.moe_{g}", prev, c_router + 1, mk_group)

        def mk_red(reqs):
            sq = sum_q(reqs)
            return OpSpec(
                "moe_reduce", post_flops=float((groups + 2) * sq * d),
                out_elems=sq * d, dataflow_neutral=True,
            )

        lo = c_shared if c_shared >= 0 else first_g
        return add(f"b{li}.moe_reduce", lo, first_g + groups, mk_red)

    prev = -1
    for li in range(n_blocks):
        if spec.attn_kind == "none" or spec.mixer_kind(li) == "mamba":
            prev = _mk_mamba_block(li, prev)
        else:
            prev = _mk_attn_block(li, prev)
            if spec.cross_attention:
                prev = _mk_cross_attn_block(li, prev)
        if spec.ffn_kind(li) == "dense":
            prev = _mk_dense_ffn(li, prev)
        elif spec.ffn_kind(li) == "moe":
            prev = _mk_moe_ffn(li, prev)

    ops = [[b(reqs) for b in per_row_ops] for reqs in rows_req]
    return ExecutionGraph(
        spec=spec, layers=layers, ops=ops, requests_per_row=rows_req,
        scale=spec.n_layers / n_blocks,
    )


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)
