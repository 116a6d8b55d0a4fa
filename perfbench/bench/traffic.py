"""The one traffic generator: it reads a traffic file's parameters and
draws requests from ``--seed``.

Three kinds of mix:

* ``stream``: requests in scheduler-iteration units for the mapping
  search, as the port's ``RequestStream`` draws them (a frozen copy of its
  clipped log-normal lengths, its Poisson gaps and its warm,
  decode-resident share);
* ``open_loop``: independent users; requests due at Poisson times over
  the window, whether or not earlier ones have finished;
* ``closed_loop``: a fixed number of clients, each sending its next
  request when the last one finishes; the run starts with every client's
  request decode-resident at a seeded progress.

``stratified`` lengths and gaps are the distribution's quantiles at
(i + 1/2) / n, in an order drawn from the seed: every seed gets the same
sizes and arrival gaps in another order.
"""
from __future__ import annotations

import math
from statistics import NormalDist

import numpy as np


def _lognormal(rng, mean: float, sigma: float, n: int, lo: int, hi: int,
               stratified: bool = False) -> np.ndarray:
    """Clipped, rounded log-normal lengths with mean ``mean`` before the
    clip (E = exp(mu + sigma^2 / 2))."""
    mu = math.log(mean) - sigma ** 2 / 2.0
    if stratified:
        z = np.array([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
        x = rng.permutation(np.exp(mu + sigma * z))
    else:
        x = rng.lognormal(mu, sigma, size=n)
    return np.clip(np.round(x), lo, hi).astype(int)


def _exponential_gaps(rng, rate: float, n: int, stratified: bool) -> np.ndarray:
    if stratified:
        u = (np.arange(n) + 0.5) / n
        return rng.permutation(-np.log1p(-u) / rate)
    return rng.exponential(1.0 / rate, size=n)


def stream_requests(t: dict, seed: int) -> list[dict]:
    """A ``stream`` mix: dicts of ``prompt_len``, ``max_new_tokens``,
    ``arrival_iter`` and ``warm_context``, drawn as the port's
    ``RequestStream.sample`` draws them (one child generator each for the
    lengths, the gaps, the warm mask and the decode progress)."""
    n = int(t["n_requests"])
    ss = np.random.SeedSequence(seed)
    len_rng, gap_rng, warm_rng, ctx_rng = (np.random.default_rng(c)
                                           for c in ss.spawn(4))
    li, lo = t["input"], t["output"]
    ins = _lognormal(len_rng, li["mean"], li["sigma"], n, t["min_len"], t["max_len"])
    outs = _lognormal(len_rng, lo["mean"], lo["sigma"], n, t["min_len"], t["max_len"])
    if t["arrival"] != "poisson":
        raise ValueError(f"unknown arrival {t['arrival']!r}")
    gaps = gap_rng.exponential(1.0 / t["rate_per_iter"], size=n)
    arrivals = np.floor(np.cumsum(gaps) - gaps[0]).astype(int)
    warm = warm_rng.random(n) < t["warm_fraction"]
    ctx_u = ctx_rng.random(n)
    cap = t.get("max_new_tokens_cap")
    out = []
    for i in range(n):
        new = int(outs[i]) if cap is None else min(int(outs[i]), int(cap))
        new = max(new, 1)
        ctx = int(ins[i] + ctx_u[i] * outs[i]) + 1 if warm[i] else 0
        out.append({"prompt_len": int(ins[i]), "max_new_tokens": new,
                    "arrival_iter": int(arrivals[i]), "warm_context": ctx})
    return out


def _prompt(rng, vocab: int, n: int) -> list[int]:
    return rng.integers(0, vocab, size=n).tolist()


def open_loop_requests(t: dict, seed: int, seconds: float, vocab: int) -> list[dict]:
    """An ``open_loop`` mix over a window of ``seconds``: the requests due
    inside it, each a dict of ``due_s``, ``prompt`` (token ids) and
    ``max_new_tokens``, in due order."""
    n = max(1, int(round(t["rate_per_s"] * seconds)))
    rng = np.random.default_rng(np.random.SeedSequence(seed).spawn(1)[0])
    strat = bool(t.get("stratified", False))
    p, o = t["prompt"], t["output"]
    plen = _lognormal(rng, p["mean"], p["sigma"], n, p["min"], p["max"], strat)
    olen = _lognormal(rng, o["mean"], o["sigma"], n, o["min"], o["max"], strat)
    gaps = _exponential_gaps(rng, t["rate_per_s"], n, strat)
    due = np.cumsum(gaps) - gaps[0]
    return [{"due_s": float(due[i]), "prompt": _prompt(rng, vocab, int(plen[i])),
             "max_new_tokens": int(olen[i])} for i in range(n)]


def closed_loop_requests(t: dict, seed: int, vocab: int) -> list[dict]:
    """A ``closed_loop`` mix: ``clients`` requests that start
    decode-resident, each with ``done`` of its output already produced (a
    seeded progress), then ``queued`` requests that take a client's place
    as one finishes. Each is a dict of ``prompt`` (for a resident request:
    its prompt and the tokens it had produced), ``max_new_tokens`` (what is
    left to produce) and ``resident``."""
    clients, queued = int(t["clients"]), int(t["queued"])
    n = clients + queued
    rng = np.random.default_rng(np.random.SeedSequence(seed).spawn(1)[0])
    strat = bool(t.get("stratified", False))
    p, o = t["prompt"], t["output"]
    plen = _lognormal(rng, p["mean"], p["sigma"], n, p["min"], p["max"], strat)
    olen = _lognormal(rng, o["mean"], o["sigma"], n, o["min"], o["max"], strat)
    progress = (np.arange(clients) + 0.5) / clients if strat else rng.random(clients)
    progress = rng.permutation(progress)
    out = []
    for i in range(n):
        if i < clients:
            done = int(progress[i] * (olen[i] - 1))
            out.append({"prompt": _prompt(rng, vocab, int(plen[i]) + done),
                        "max_new_tokens": int(olen[i]) - done, "resident": True})
        else:
            out.append({"prompt": _prompt(rng, vocab, int(plen[i])),
                        "max_new_tokens": int(olen[i]), "resident": False})
    return out
