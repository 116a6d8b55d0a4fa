#!/usr/bin/env python3
"""Time the split-S decode kernel on the card under several split plans
and kernel variants.

For each kernel variant (``--variant kStages=3,kMinBlocks=1`` rewrites
those ``constexpr int`` constants of ``csrc/decode_attention.cu`` into a
copy under ``build/``, builds it and times it in place of the checked-in
kernel; several ``--variant`` flags are timed in turn, the checked-in
source first), for each plan setting (``BLOCKS_PER_SM`` x ``MIN_SPLIT_LEN`` of
``repro_torch.kernels.decode_attention``), each of chip_smoke's decode
timing shapes (B 8, Hq 24, Hkv 8, D 128, S 1024 and 8192, seeded lengths)
and each (q, cache) type pair, prints one JSON line: the plan (n_split,
split_len), the kernel's CUDA-event time per call over back-to-back calls,
its device time per call from ``torch.profiler`` (split and combine kernels
summed), and the same two for ``scaled_dot_product_attention`` on the same
inputs, beside the byte bound. The plan's defaults come first; the kernel
is held to its plain version under each plan before it is timed. Needs one
CUDA card; the card's name and power limit are printed last.

Run from the repository root:  python3 tools/decode_split_sweep.py
[--plans default] [--variant NAME=VALUE,...]...
"""
import argparse
import ctypes
import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

# (BLOCKS_PER_SM, MIN_SPLIT_LEN); None = the module's defaults
PLANS = [None, (2, 256), (4, 256), (2, 128), (4, 128), (8, 128), (2, 64),
         (4, 64), (16, 64)]
SHORT_PLANS = [None, (4, 64), (8, 128), (16, 64)]
PAIRS = [("bfloat16", "bfloat16"), ("float32", "float32"),
         ("float32", "bfloat16"), ("bfloat16", "float32")]


def device_ms(how: str, inp: dict, calls: int = 20) -> tuple[float, int]:
    """Device time per call from the profiler, and the kernel records it
    saw (``calls`` per device kernel of a call, unless it dropped some)."""
    def run():
        for _ in range(calls):
            cs.run_attention("decode_attention", inp, how)

    run()
    _, kern = cs._profiled(run)
    mine = [e for e in kern if how == "library"
            or "decode_attention" in e.key]
    return cs._device_ms_per_call(mine, calls), sum(e.count for e in mine)


def variant_lib(spec: str):
    """The decode library built from a copy of its source with the
    ``constexpr int`` constants of ``spec`` (NAME=VALUE,...) rewritten."""
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as da

    src = (build.CSRC / da._SOURCE).read_text()
    for item in spec.split(","):
        name, value = item.split("=")
        src, n = re.subn(rf"constexpr int {name} = [^;]+;",
                         f"constexpr int {name} = {value};", src)
        if n != 1:
            raise SystemExit(f"no single constant {name} in {da._SOURCE}")
    tag = re.sub(r"[^A-Za-z0-9]+", "_", spec)
    path = build.build_dir() / f"decode_attention_{tag}.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(src)
    return da.bind(ctypes.CDLL(str(build.compile_source(str(path)))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--plans", choices=("all", "short", "default"),
                    default="all")
    ap.add_argument("--variant", action="append", default=[])
    args = ap.parse_args(argv)

    import torch

    from repro_torch.kernels import decode_attention as da

    if not torch.cuda.is_available():
        print("decode_split_sweep: needs a CUDA card", file=sys.stderr)
        return 2
    checked_in, tile = da._lib, da.TILE
    for spec in [None, *args.variant]:
        da._lib = checked_in if spec is None else \
            (lambda lib=variant_lib(spec): lib)
        # a variant's tile is the plan's tile too
        found = re.search(r"kTile=(\d+)", spec or "")
        da.TILE = int(found.group(1)) if found else tile
        sweep(da, spec, {"all": PLANS, "short": SHORT_PLANS,
                         "default": [None]}[args.plans])
    da._lib, da.TILE = checked_in, tile
    print(cs.card_line(), flush=True)
    return 0


def sweep(da, spec, plans) -> None:
    import torch

    defaults = (da.BLOCKS_PER_SM, da.MIN_SPLIT_LEN)
    for plan in plans:
        da.BLOCKS_PER_SM, da.MIN_SPLIT_LEN = plan or defaults
        for i, shape in enumerate(cs.DECODE_TIMES):
            for q_dtype, kv_dtype in PAIRS:
                inp = cs.decode_inputs(shape, kv_dtype, seed=100 + i)
                inp["q"] = inp["q"].to(getattr(torch, q_dtype))
                got = cs.run_attention("decode_attention", inp, "cuda")
                want = cs.run_attention("decode_attention", inp,
                                        "plain_split")
                err = float((got.float() - want.float()).abs().max())
                cs.check(err <= cs.ATTN_TOLS[q_dtype],
                         f"{shape} {q_dtype}/{kv_dtype}: err {err}")
                rec = {"variant": spec, "blocks_per_sm": da.BLOCKS_PER_SM,
                       "min_split_len": da.MIN_SPLIT_LEN,
                       "default": plan is None, "shape": list(shape),
                       "q": q_dtype, "cache": kv_dtype,
                       "plan": da.kernel_plan(inp["q"], inp["k"],
                                               inp["v"])._asdict(),
                       "max_abs_err": err}
                # the library call takes one type: same-type pairs only
                hows = (("cuda", "kernel"), ("library", "library")) \
                    if q_dtype == kv_dtype else (("cuda", "kernel"),)
                for how, key in hows:
                    rec[f"{key}_ms"] = cs._time_ms(
                        lambda how=how: cs.run_attention(
                            "decode_attention", inp, how), 20)
                    rec[f"{key}_device_ms"], rec[f"{key}_records"] = \
                        device_ms(how, inp)
                rec["bound_ms"] = cs.attention_bound("decode_attention",
                                                     inp)["bound_ms"]
                print(json.dumps(rec), flush=True)
    da.BLOCKS_PER_SM, da.MIN_SPLIT_LEN = defaults


if __name__ == "__main__":
    sys.exit(main())
