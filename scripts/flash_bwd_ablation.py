#!/usr/bin/env python3
"""Where the wgmma flash backward spends its time, on one NVIDIA card.

    python3 scripts/flash_bwd_ablation.py [--rounds N]

Builds copies of ``panacea_tpu_torch/csrc/flash_attention_bwd.cu`` side by
side with nvcc, each with one change, and times each pass of the head-dim-64
route (Delta, dK/dV, dQ: device time under torch.profiler) at the training
levels (B 40; Sq 2048 / 512 / 128, Skv = 2 Sq). The variants, timed in turns:

  base      the source as it is;
  int_pack  the bf16 rounding of P and dS done with integer arithmetic
            instead of the conversion instruction (the same results; checked
            against the plain version);
  no_ex2    the exponential replaced by a copy (wrong results, timing only).

ptxas's advisories (C75xx: serialised wgmma) are printed per variant, since a
serialised variant times something else. The last line is one JSON object.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EX2 = 'asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));'
PACK = """  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);"""
INT_PACK = """  uint32_t a = __float_as_uint(lo), b = __float_as_uint(hi);
  a += 0x7fffu + ((a >> 16) & 1u);
  b += 0x7fffu + ((b >> 16) & 1u);
  return __byte_perm(a, b, 0x7632);"""
VARIANTS = {"base": [], "int_pack": [("hopper.cuh", PACK, INT_PACK)],
            "no_ex2": [("flash_attention_bwd.cu", EX2, "y = x;")]}
LEVELS = ((2048, 4096, 5), (512, 1024, 10), (128, 256, 20))
PASSES = (("delta", "bwd_delta"), ("dkdv", "dkdv_wg"), ("dq", "dq_wg"))


def build(out: str) -> dict:
    """Every variant's library, built in parallel: name -> ctypes.CDLL."""
    from panacea_tpu_torch.ops import _build

    procs = {}
    for name, subs in VARIANTS.items():
        d = os.path.join(out, name)
        os.makedirs(d)
        for f in ("hopper.cuh", "flash_attention_bwd.cu"):
            with open(os.path.join(_build.CSRC, f)) as fh:
                text = fh.read()
            for target, old, new in subs:
                if target == f:
                    if text.count(old) != 1:
                        raise RuntimeError(f"{name}: the text to replace is not in {f} once")
                    text = text.replace(old, new)
            with open(os.path.join(d, f), "w") as fh:
                fh.write(text)
        procs[name] = subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", os.path.join(d, "lib.so"),
             os.path.join(d, "flash_attention_bwd.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        for line in log.splitlines():
            if "(C75" in line:
                print(f"{name} ptxas: {line.strip()[:160]}", flush=True)
        lib = ctypes.CDLL(os.path.join(out, name, "lib.so"))
        lib.pn_error_string.argtypes = [ctypes.c_int]
        lib.pn_error_string.restype = ctypes.c_char_p
        lib.pn_flash_attention_bwd_bf16.argtypes = (
            [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5
            + [ctypes.POINTER(ctypes.c_longlong)] * 2 + [ctypes.c_float, ctypes.c_void_p])
        lib.pn_flash_attention_bwd_bf16.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("flash_bwd_ablation: no CUDA device", file=sys.stderr)
        return 2
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rounds", type=int, default=2)
    args = parser.parse_args()
    sys.path.insert(0, ROOT)
    from torch.profiler import ProfilerActivity, profile

    from panacea_tpu_torch.ops import flash_attention as fa
    from panacea_tpu_torch.ops import tolerance as tol

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda")
    out = tempfile.mkdtemp(prefix="flash_bwd_ablation_")
    try:
        libs = build(out)
        own_lib = fa._bwd_lib
        ms: dict = {}
        for rnd in range(args.rounds):
            for name, lib in libs.items():
                fa._bwd_lib = lambda lib=lib: lib
                for sq, skv, h in LEVELS:
                    g = torch.Generator(device=dev).manual_seed(sq)
                    q = torch.randn((40, sq, h, 64), generator=g, device=dev).bfloat16()
                    kv = torch.randn((40, skv, 2 * h * 64), generator=g, device=dev).bfloat16()
                    k, v = (t.unflatten(-1, (h, 64)) for t in kv.chunk(2, dim=-1))
                    do = torch.randn((40, sq, h, 64), generator=g, device=dev).bfloat16()
                    o, lse = fa.flash_attention_with_lse(q, k, v)
                    got = fa.flash_attention_bwd(q, k, v, o, lse, do)
                    if rnd == 0 and name != "no_ex2" and sq == 512:
                        want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do)
                        worst = max(tol.worst_ratio(a, w, **tol.FLASH_BWD)
                                    for a, w in zip(got, want))
                        if not worst <= 1.0:
                            raise AssertionError(f"{name} disagrees with the plain version")
                    torch.cuda.synchronize()
                    with profile(activities=[ProfilerActivity.CUDA]) as prof:
                        for _ in range(3):
                            fa.flash_attention_bwd(q, k, v, o, lse, do)
                        torch.cuda.synchronize()
                    for evt in prof.key_averages():
                        for label, key in PASSES:
                            if key in evt.key:
                                ms.setdefault(name, {}).setdefault(f"{label}_sq{sq}", []).append(
                                    evt.self_device_time_total / 3e3)
        fa._bwd_lib = own_lib
    finally:
        shutil.rmtree(out, ignore_errors=True)
    print(json.dumps({"card": card, "ms_device_per_round": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
