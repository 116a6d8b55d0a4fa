#!/usr/bin/env python3
"""Time the float32 flash attention kernel on the card beside variants of
its source that leave a part of the work out, to see where its time goes.

Each variant is a copy of ``csrc/flash_attention.cu`` under ``build/`` with
a few lines of ``flash_attention_kernel`` rewritten (``VARIANTS``):
``no-score-product`` skips the Q K^T loop, ``no-pv-product`` the P V loop,
``no-products`` both, and ``no-loads`` the copy of every K and V tile
after the first (the products then read stale tiles). No variant computes
the function, so only the checked-in source is held to the plain version.
At each of chip_smoke's flash timing shapes (B 2 or 1, Hq 24, Hkv 8,
D 128, causal: L 512, Lq 100 < Lk 512, L 2048), float32, prints one JSON
line: each build's CUDA-event time per call (in turns: checked-in,
variants, variants in reverse, checked-in) and its device time per call
from ``torch.profiler``, beside the operation bound. Needs one CUDA card;
the card's name and power limit are printed last.

Run from the repository root:  python3 tools/flash_f32_variant_times.py
"""
import ctypes
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

_SCORE = ("    for (int ch = 0; ch < kChunks; ++ch) {",
          "    for (int ch = 0; ch < (lq < 0 ? kChunks : 0); ++ch) {")
_PV = ("    for (int t4 = 0; t4 < kF32BK; t4 += 4) {",
       "    for (int t4 = 0; t4 < (lq < 0 ? kF32BK : 0); t4 += 4) {")
# name -> (old text, new text) pairs, each found exactly once in the source
VARIANTS = {
    "no-score-product": [_SCORE],
    "no-pv-product": [_PV],
    "no-products": [_SCORE, _PV],
    "no-loads": [("    fetch_v(t);", "    if (t == 0) fetch_v(t);"),
                 ("    fetch_k(t + 1);", "    (void)0;")],
}


def variant_lib(name: str):
    """The flash library built from a copy of its source with
    VARIANTS[name] applied."""
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa

    src = (build.CSRC / fa._SOURCE).read_text()
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise SystemExit(f"{name}: {old!r} is not in {fa._SOURCE} once")
        src = src.replace(old, new)
    path = build.build_dir() / f"flash_attention_{name.replace('-', '_')}.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(src)
    return fa.bind(ctypes.CDLL(str(build.compile_source(str(path)))))


def device_ms(inp: dict, calls: int = 10) -> float | None:
    """Device ms per call of the float32 kernel from ``torch.profiler``."""
    def run():
        for _ in range(calls):
            cs.run_attention("flash_attention", inp, "cuda")

    run()
    for _ in range(5):   # the profiler now and then records nothing
        _, kern = cs._profiled(run)
        mine = [e for e in kern if "flash_attention_kernel" in e.key]
        if mine:
            return cs._device_ms_per_call(mine, calls)
    return None


def main() -> int:
    import torch

    from repro_torch.kernels import flash_attention as fa

    if not torch.cuda.is_available():
        print("flash_f32_variant_times: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = {"checked-in": fa._lib()}
    libs.update({name: variant_lib(name) for name in VARIANTS})
    checked_in = fa._lib
    order = list(libs) + list(libs)[::-1]
    for i, shape in enumerate(cs.FLASH_TIMES):
        inp = cs.flash_inputs(shape, "float32", seed=100 + i)
        got = cs.run_attention("flash_attention", inp, "cuda")
        want = cs.run_attention("flash_attention", inp, "plain")
        err = float((got - want).abs().max())
        cs.check(err <= cs.ATTN_TOLS["float32"],
                 f"flash_attention {shape}: err {err}")
        rec = {"shape": list(shape), "dtype": "float32",
               "event_ms": {k: [] for k in libs}, "device_ms": {}}
        for name in order:
            fa._lib = lambda lib=libs[name]: lib
            rec["event_ms"][name].append(cs._time_ms(
                lambda: cs.run_attention("flash_attention", inp, "cuda"), 20))
        for name, lib in libs.items():
            fa._lib = lambda lib=lib: lib
            rec["device_ms"][name] = device_ms(inp)
        fa._lib = checked_in
        rec["bound_ms"] = cs.attention_bound("flash_attention", inp)["bound_ms"]
        print(json.dumps(rec), flush=True)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
