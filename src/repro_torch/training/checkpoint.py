"""Fault-tolerant checkpointing, a copy of the JAX package's
``training/checkpoint.py``: flattened ``.npz`` files, atomic rename,
optional async writer thread, resumable data-iterator state.

The file layout and its key paths are the reference's
(``params/blocks/[0]/attn/wq/w``, ``opt/mu/...``, ``opt/step``), so a
checkpoint of either package restores into the other. A tree here is
dicts (a key with dots, such as a parameter name ``blocks.0.attn.wq.w``,
is a path of several levels), lists, tensors and
:class:`torch.nn.Module`s (their named parameters).

Restart contract: ``latest_step(dir)`` -> ``restore(dir, step, like=...)``
reproduces params, optimizer state, and the data counter exactly; a killed
run resumes bit-identically (tested).
"""
from __future__ import annotations

import copy
import json
import os
import re
import threading
from typing import Any

import numpy as np
import torch
from torch import nn


def _path(key) -> str:
    """A tree key as the reference's path: list indices as ``[i]``, a
    dotted name as one level per part."""
    if isinstance(key, int):
        return f"[{key}]"
    return "/".join(f"[{p}]" if p.isdigit() else p for p in str(key).split("."))


def _items(tree):
    if isinstance(tree, nn.Module):
        return tree.named_parameters()
    if isinstance(tree, dict):
        return tree.items()
    if isinstance(tree, (list, tuple)):
        return enumerate(tree)
    return None


def _flatten(tree, prefix: str = "") -> dict[str, torch.Tensor]:
    items = _items(tree)
    if items is None:
        return {prefix: tree}
    flat = {}
    for key, sub in items:
        path = _path(key)
        flat.update(_flatten(sub, f"{prefix}/{path}" if prefix else path))
    return flat


def _host(t) -> np.ndarray:
    """A tensor's values as a numpy array of its own (never a view of the
    tensor's storage, which later steps overwrite in place)."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy().copy()
    return np.array(t)


def _write(ckpt_dir: str, step: int, flat: dict, extra: dict | None,
           keep: int) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f".tmp_step_{step:08d}.npz")
    final = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    np.savez(tmp, **flat)
    if extra is not None:
        with open(tmp + ".json", "w") as f:
            json.dump(extra, f)
        os.replace(tmp + ".json", final + ".json")
    os.replace(tmp, final)
    _prune(ckpt_dir, keep)
    return final


def save(ckpt_dir: str, step: int, tree: Any, extra: dict | None = None,
         keep: int = 3):
    """Atomic checkpoint write: tmp file + rename, then prune old steps."""
    flat = {k: _host(v) for k, v in _flatten(tree).items()}
    return _write(ckpt_dir, step, flat, extra, keep)


_ASYNC_THREADS: list[threading.Thread] = []


def save_async(ckpt_dir: str, step: int, tree: Any, extra: dict | None = None,
               keep: int = 3):
    """Background checkpoint write (the device->host copy happens here, on
    the caller thread, so the snapshot is consistent; the disk IO overlaps
    the next training steps)."""
    flat = {k: _host(v) for k, v in _flatten(tree).items()}
    t = threading.Thread(target=_write,
                         args=(ckpt_dir, step, flat, extra, keep),
                         daemon=True)
    t.start()
    _ASYNC_THREADS.append(t)
    return t


def wait_pending():
    for t in _ASYNC_THREADS:
        t.join()
    _ASYNC_THREADS.clear()


def _prune(ckpt_dir: str, keep: int):
    steps = sorted(all_steps(ckpt_dir))
    for s in steps[:-keep] if keep > 0 else []:
        for suffix in ("", ".json"):
            p = os.path.join(ckpt_dir, f"step_{s:08d}.npz{suffix}")
            if os.path.exists(p):
                os.remove(p)


def all_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)\.npz", name)
        if m:
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(ckpt_dir: str) -> int | None:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def _load(like, data, prefix: str, device):
    """A tree shaped as ``like`` holding the file's values: tensors on
    ``device`` (or where ``like``'s lie), a module as a copy of ``like``'s
    with its parameters replaced (keeping their ``requires_grad``)."""
    if isinstance(like, nn.Module):
        out = copy.deepcopy(like)
        with torch.no_grad():
            for key, p in out.named_parameters():
                p.copy_(_load(p, data, f"{prefix}/{_path(key)}", device))
        return out
    items = _items(like)
    if items is None:
        dev = device if device is not None else getattr(like, "device", None)
        return torch.as_tensor(data[prefix], device=dev)
    sub = {key: _load(v, data, f"{prefix}/{_path(key)}" if prefix
                      else _path(key), device) for key, v in items}
    return list(sub.values()) if isinstance(like, (list, tuple)) else sub


def restore(ckpt_dir: str, step: int, like: Any,
            device=None) -> tuple[Any, dict]:
    """Restore a tree saved with ``save`` (by this package or the JAX
    package); ``like`` supplies the structure, and the place of each leaf
    unless ``device`` is given."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    with np.load(path) as data:
        tree = _load(like, data, "", device)
    extra = {}
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            extra = json.load(f)
    return tree, extra
