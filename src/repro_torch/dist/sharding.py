"""Partition rules for params and KV/state caches on the production meshes,
ported rule for rule from the JAX package's ``dist/sharding.py``.

Mesh axes: ``("pod", "data", "model")`` (multi-pod) or ``("data", "model")``.
The rules are name + shape driven (Megatron-style tensor parallelism over
``model``, FSDP/batch over ``(pod, data)``) with divisibility fallbacks:

* column-parallel projections (``wq/wk/wv/wi/in_proj/w_dkv/lm_head``):
  output dim over ``model``;
* row-parallel projections (``wo/out_proj``): input dim over ``model``;
* embeddings: vocab dim over ``model``;
* MoE banks (3-D ``[experts, d_in, d_out]``): experts over ``model`` (EP),
  first inner dim over ``(pod, data)`` (FSDP);
* caches: batch over ``(pod, data)``; KV heads over ``model`` when they
  divide, else sequence-parallel over ``model``; mamba state heads over
  ``model``; every indivisible dim falls back to unsharded.

Stacked layouts (``blocks_stacked/...`` params, scan-over-layers caches with
a leading ``[n_steps]`` dim) get a leading ``None`` and the same trailing
rules.

A spec is a tuple with one entry per dimension, equal entry for entry to
the reference's ``PartitionSpec``: ``None`` (replicated), an axis name, or
a tuple of axis names. A mesh is anything with ``axis_names`` and a
``shape`` dict (:class:`repro_torch.launch.mesh.Mesh`). The port places
these specs on no device: it has no SPMD partitioner, and its launcher
runs on one device (ROADMAP R6 a). The dry run reads them for the bytes
each device would hold (:func:`shard_shape`).
"""
from __future__ import annotations

import math

BATCH_AXES = ("pod", "data")
MODEL_AXIS = "model"

_COL_PARALLEL = {"wq", "wk", "wv", "wi", "w_dkv", "w_uk", "w_uv", "in_proj",
                 "lm_head", "x_proj", "dt_proj"}
_ROW_PARALLEL = {"wo", "out_proj"}


def _axis_sizes(mesh) -> dict:
    return {name: int(mesh.shape[name]) for name in mesh.axis_names}


def _fit(mesh, size: int, axes) -> str | tuple | None:
    """Largest prefix-complete fit of ``axes`` onto ``size``: axes absent
    from the mesh are dropped; if the remaining product does not divide the
    dim the whole entry falls back to ``None`` (no partial sharding)."""
    if isinstance(axes, str):
        axes = (axes,)
    sizes = _axis_sizes(mesh)
    names = tuple(a for a in axes if a in sizes)
    if not names:
        return None
    total = math.prod(sizes[n] for n in names)
    if total <= 0 or int(size) % total:
        return None
    return names if len(names) > 1 else names[0]


def _path_parts(name: str) -> list[str]:
    return [p for p in name.split("/") if p]


def param_partition_spec(name: str, shape, mesh) -> tuple:
    """Partition spec for one parameter leaf. ``name`` is the '/'-joined
    tree path (e.g. ``blocks/0/attn/wq/w``)."""
    parts = _path_parts(name)
    stacked = any(p.endswith("_stacked") for p in parts)
    dims = list(shape)
    lead: list = []
    if stacked and len(dims) >= 2:
        lead = [None]
        dims = dims[1:]

    spec: list = [None] * len(dims)
    leaf = parts[-1]
    owner = parts[-2] if len(parts) >= 2 else ""

    if "moe" in parts and len(dims) == 3:
        # expert bank [E, d_in, d_out]: EP over model, FSDP over (pod, data)
        spec[0] = _fit(mesh, dims[0], MODEL_AXIS)
        spec[1] = _fit(mesh, dims[1], BATCH_AXES)
    elif owner == "embed" or leaf == "e":
        spec[0] = _fit(mesh, dims[0], MODEL_AXIS)
    elif len(dims) == 2 and (owner in _COL_PARALLEL or leaf in _COL_PARALLEL):
        spec[1] = _fit(mesh, dims[1], MODEL_AXIS)
    elif len(dims) == 2 and (owner in _ROW_PARALLEL or leaf in _ROW_PARALLEL):
        spec[0] = _fit(mesh, dims[0], MODEL_AXIS)
    # 1-D leaves (norm scales, biases, a_log, ...) stay replicated

    return tuple(lead + spec)


def cache_partition_spec(name: str, shape, mesh) -> tuple:
    """Partition spec for one KV/state-cache leaf (keys like ``0/k``,
    ``0/kv``, ``0/state``, ``0/len``; scan-stacked leaves carry a leading
    [n_steps] dim)."""
    leaf = _path_parts(name)[-1]
    dims = list(shape)
    lead: list = []

    if leaf == "len":
        if len(dims) == 2:                       # stacked [steps, B]
            lead, dims = [None], dims[1:]
        return tuple(lead + [_fit(mesh, dims[0], BATCH_AXES)])

    if leaf == "state":
        if len(dims) == 5:                       # stacked [steps, B, H, N, Pd]
            lead, dims = [None], dims[1:]
        spec = [_fit(mesh, dims[0], BATCH_AXES),
                _fit(mesh, dims[1], MODEL_AXIS), None, None]
        return tuple(lead + spec)

    # attention caches k / v / kv / *_scale: [B, L, H, D]
    if len(dims) == 5:
        lead, dims = [None], dims[1:]
    if len(dims) != 4:
        return (None,) * len(shape)
    batch = _fit(mesh, dims[0], BATCH_AXES)
    heads = _fit(mesh, dims[2], MODEL_AXIS)
    if heads is not None:
        spec = [batch, None, heads, None]
    else:                                        # sequence-parallel fallback
        spec = [batch, _fit(mesh, dims[1], MODEL_AXIS), None, None]
    return tuple(lead + spec)


# ---------------------------------------------------------------------------
# tree-level helpers
# ---------------------------------------------------------------------------


def param_path(name: str) -> str:
    """A parameter name of :func:`~repro_torch.training.optimizer.named_leaves`
    (``blocks_stacked.0.attn.wq.w``) as the reference's tree path
    (``blocks_stacked/0/attn/wq/w``)."""
    return name.replace(".", "/")


def make_param_shardings(mesh, params) -> dict:
    """Spec of every tensor of ``params`` (a model, stacked or not), keyed
    by its name in the reference's flatten order."""
    from ..training.optimizer import named_leaves

    return {name: param_partition_spec(param_path(name), t.shape, mesh)
            for name, t in named_leaves(params).items()}


def make_cache_shardings(mesh, cache) -> list:
    """Spec of every tensor of a cache (a list of per-layer or, stacked,
    per-slot dicts), in the cache's own structure; leaf ``k`` of entry
    ``i`` is named ``i/k``."""
    return [{k: cache_partition_spec(f"{i}/{k}", t.shape, mesh)
             for k, t in layer.items()} for i, layer in enumerate(cache)]


def token_sharding(mesh, global_batch: int) -> tuple:
    return (_fit(mesh, global_batch, BATCH_AXES), None)


def shard_shape(shape, spec, mesh) -> tuple:
    """One device's local shape of a tensor of ``shape`` under ``spec``
    (each sharded dim divided by the product of its axes' sizes, rounded
    up, as a partitioner pads)."""
    sizes = _axis_sizes(mesh)
    out = []
    for d, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        axes = () if entry is None else \
            (entry,) if isinstance(entry, str) else tuple(entry)
        n = math.prod(sizes[a] for a in axes)
        out.append(-(-int(d) // n))
    return tuple(out)


def constrain(x, spec_axes, mesh):
    """Activation sharding constraint: ``x`` itself when ``mesh`` is None
    or has one device. A larger mesh raises ``NotImplementedError``: the
    port has no SPMD partitioner to hand the constraint to (ROADMAP R6 a)."""
    if mesh is None or math.prod(_axis_sizes(mesh).values()) == 1:
        return x
    raise NotImplementedError(
        "constrain on a mesh of more than one device: the port has no SPMD "
        "partitioner and runs on one device (ROADMAP R6 a)")
