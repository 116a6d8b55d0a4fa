#!/usr/bin/env python3
"""Time the SSD scan kernels on the card beside variants of their source
that leave a part of the work out, to see where their time goes.

Each variant is a copy of ``csrc/ssd_scan.cu`` under ``build/`` with a
few lines rewritten (``VARIANTS``): ``no-products`` skips the register-tile
products of both kernels, ``no-loads`` skips the ring's prefetch of every
slice after the first (the products then read stale tiles), so neither
computes the function and only the checked-in source is held to the plain
version. At each of chip_smoke's SSD timing shapes (B 2, H 80, P 64, N 128,
L 512 and 4096) and in float32 and bfloat16, prints one JSON line: each
build's CUDA-event time per call (in turns: checked-in, variants, variants
in reverse, checked-in) and its device time per device kernel from
``torch.profiler``, beside the operation bound. Needs one CUDA card; the
card's name and power limit are printed last.

Run from the repository root:  python3 tools/ssd_variant_times.py
"""
import ctypes
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

# name -> (old text, new text) pairs, each found exactly once in the source
VARIANTS = {
    "no-products": [
        ("    mm_outer<kSK>(acc, bw, kWB, xw, kWX, ng * 4, pg * 4);",
         "    if (d.len < 0) mm_outer<kSK>(acc, bw, kWB, xw, kWX, ng * 4, "
         "pg * 4);"),
        ("    if (kn > 0) mm_rows<4, kYK, kGP, kSP2>(",
         "    if (kn < 0) mm_rows<4, kYK, kGP, kSP2>("),
    ],
    "no-loads": [
        ("    if (g + 1 < halves) load_half(g + 1);", "    (void)0;"),
        ("    if (s + 1 < slices) load_slice(s + 1);\n    cp_async_commit();\n"
         "    cp_async_wait<1>();",
         "    cp_async_commit();\n    cp_async_wait<1>();"),
    ],
}


def variant_lib(name: str):
    """The SSD library built from a copy of its source with VARIANTS[name]
    applied."""
    from repro_torch.kernels import build
    from repro_torch.kernels import ssd_scan as ss

    src = (build.CSRC / ss._SOURCE).read_text()
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise SystemExit(f"{name}: {old!r} is not in {ss._SOURCE} once")
        src = src.replace(old, new)
    path = build.build_dir() / f"ssd_scan_{name.replace('-', '_')}.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(src)
    return ss.bind(ctypes.CDLL(str(build.compile_source(str(path)))))


def device_ms(inp: dict, calls: int = 10) -> dict:
    """Device ms per call of each device kernel of the SSD kernels."""
    def run():
        for _ in range(calls):
            cs.run_ssd(inp, "cuda")

    run()
    for _ in range(5):   # the profiler now and then records nothing
        _, kern = cs._profiled(run)
        got = {e.key[:60]: cs._dev_us(e) / e.count / 1e3 for e in kern
               if "ssd_" in e.key and e.count}
        if got:
            return got
    return {}


def main() -> int:
    import torch

    from repro_torch.kernels import ssd_scan as ss

    if not torch.cuda.is_available():
        print("ssd_variant_times: needs a CUDA card", file=sys.stderr)
        return 2
    libs = {"checked-in": ss._lib()}
    libs.update({name: variant_lib(name) for name in VARIANTS})
    checked_in = ss._lib
    order = list(libs) + list(libs)[::-1]
    for i, shape in enumerate(cs.SSD_TIMES):
        for dtype, tol in cs.SSD_TOLS.items():
            inp = cs.ssd_inputs(shape, dtype, seed=200 + i)
            got, want = cs.run_ssd(inp, "cuda"), cs.run_ssd(inp, "plain")
            for g, w in zip(got, want):
                err = float((g.float() - w.float()).abs().max())
                cs.check(err <= tol * float(w.float().abs().max()),
                         f"ssd_scan {shape} {dtype}: err {err}")
            rec = {"shape": list(shape), "dtype": dtype,
                   "event_ms": {k: [] for k in libs}, "device_ms": {}}
            for name in order:
                ss._lib = lambda lib=libs[name]: lib
                rec["event_ms"][name].append(cs._time_ms(
                    lambda: cs.run_ssd(inp, "cuda"), 20))
            for name, lib in libs.items():
                ss._lib = lambda lib=lib: lib
                rec["device_ms"][name] = device_ms(inp)
            ss._lib = checked_in
            rec["bound_ms"] = cs.ssd_bound(inp)["bound_ms"]
            print(json.dumps(rec), flush=True)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
