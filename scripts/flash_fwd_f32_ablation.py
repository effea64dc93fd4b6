#!/usr/bin/env python3
"""Where the fp32 flash forward on the tensor cores spends its time, on one
NVIDIA card.

    python3 scripts/flash_fwd_f32_ablation.py [--rounds N]

Builds copies of ``panacea_tpu_torch/csrc/flash_attention.cu`` (with
``hopper.cuh`` and ``flash_f32_tc.cuh``) side by side with nvcc, each with
one change, and times the head-dim-64 fp32 kernel (``tc::pn_flash_f32_fwd_tc``,
CUDA events over 10 calls) at the sampling path's levels (B 80; Sq 2048 /
512 / 128, Skv = 2 Sq, k and v the halves of the merged kv projection). The
variants, timed in turns:

  base         the sources as they are;
  cvt_round    the TF32 rounding by the conversion instruction
               (cvt.rna.tf32.f32) instead of integer arithmetic on the bits
               (its results checked bit-equal to base's);
  no_split     the K and V tiles not split (wrong results, timing only);
  one_product  one TF32 product in place of three in Q K^T and P V (wrong
               results, timing only);
  no_ex2       the exponential replaced by a copy (wrong results, timing only).

ptxas's register report and advisories (C75xx: serialised wgmma) are printed
per variant. The last line is one JSON object.
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
SOURCES = ("flash_attention.cu", "hopper.cuh", "flash_f32_tc.cuh")
INT_ROUND = "  return __uint_as_float((__float_as_uint(a) + 0x1000u) & 0xFFFFE000u);"
CVT_ROUND = """  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(r) : "f"(a));
  return __uint_as_float(r & 0xFFFFE000u);"""
SPLIT = ("    split_tile<false, true, 8>(sl.k, sl.k_small, nullptr, nullptr, "
         "threadIdx.x >> 5, lane);\n"
         "    split_tile<true, false, 8>(sl.v, nullptr, sl.vt[0], sl.vt[1], "
         "threadIdx.x >> 5, lane);\n")
S3 = """    wgmma_m64n32k8_tf32_rs(set, a_small[kk], smem_desc(b_big + bo), kk % PER_SET != 0);
    wgmma_m64n32k8_tf32_rs(set, a_big[kk], smem_desc(b_small + bo), 1);
    wgmma_m64n32k8_tf32_rs(set, a_big[kk], smem_desc(b_big + bo), 1);"""
S1 = "    wgmma_m64n32k8_tf32_rs(set, a_big[kk], smem_desc(b_big + bo), kk % PER_SET != 0);"
PV3 = """    wgmma_m64n64k8_tf32_rs(acc, a_small[kk], smem_desc(b_big + kk * 32), kk > 0);
    wgmma_m64n64k8_tf32_rs(acc, a_big[kk], smem_desc(b_small + kk * 32), 1);
    wgmma_m64n64k8_tf32_rs(acc, a_big[kk], smem_desc(b_big + kk * 32), 1);"""
PV1 = "    wgmma_m64n64k8_tf32_rs(acc, a_big[kk], smem_desc(b_big + kk * 32), kk > 0);"
EX2 = "      s[i] = wg::ex2(s[i] - m[(i >> 1) & 1]);"
VARIANTS = {"base": [], "cvt_round": [("hopper.cuh", INT_ROUND, CVT_ROUND)],
            "no_split": [("flash_attention.cu", SPLIT, "")],
            "one_product": [("flash_f32_tc.cuh", S3, S1), ("flash_f32_tc.cuh", PV3, PV1)],
            "no_ex2": [("flash_attention.cu", EX2, "      s[i] = s[i] - m[(i >> 1) & 1];")]}
EXACT = ("base", "cvt_round")   # variants whose results are the kernel's
LEVELS = ((2048, 4096, 5), (512, 1024, 10), (128, 256, 20))


def build(out: str) -> dict:
    """Every variant's library, built in parallel: name -> ctypes.CDLL."""
    from panacea_tpu_torch.ops import _build

    procs = {}
    for name, subs in VARIANTS.items():
        d = os.path.join(out, name)
        os.makedirs(d)
        for f in SOURCES:
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
             os.path.join(d, "flash_attention.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if "(C75" in line:
                print(f"{name} ptxas: {line.strip()[:160]}", flush=True)
            if "pn_flash_f32_fwd_tc" in line:   # its spill and register lines follow
                for after in lines[i + 1:i + 4]:
                    if "spill" in after or "registers" in after:
                        print(f"{name} ptxas: {after.strip()[:160]}", flush=True)
        lib = ctypes.CDLL(os.path.join(out, name, "lib.so"))
        lib.pn_error_string.argtypes = [ctypes.c_int]
        lib.pn_error_string.restype = ctypes.c_char_p
        for entry in (lib.pn_flash_attention_bf16, lib.pn_flash_attention_f32):
            entry.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong),
                ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_void_p]
            entry.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("flash_fwd_f32_ablation: no CUDA device", file=sys.stderr)
        return 2
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rounds", type=int, default=2)
    args = parser.parse_args()
    sys.path.insert(0, ROOT)
    from chip_smoke import time_ms
    from panacea_tpu_torch.ops import flash_attention as fa

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda")
    out = tempfile.mkdtemp(prefix="flash_fwd_f32_ablation_")
    ms: dict = {}
    try:
        libs = build(out)
        own_lib = fa._lib
        base_out = {}
        for rnd in range(args.rounds):
            for name, lib in libs.items():
                fa._lib = lambda lib=lib: lib
                for sq, skv, h in LEVELS:
                    g = torch.Generator(device=dev).manual_seed(sq)
                    q = torch.randn((80, sq, h, 64), generator=g, device=dev)
                    kv = torch.randn((80, skv, 2 * h * 64), generator=g, device=dev)
                    k, v = (t.unflatten(-1, (h, 64)) for t in kv.chunk(2, dim=-1))
                    if rnd == 0 and name in EXACT:
                        got = fa.flash_attention(q, k, v)
                        if name == "base":
                            base_out[sq] = got
                        elif not torch.equal(got, base_out[sq]):
                            raise AssertionError(f"{name} differs from base at Sq {sq}")
                    ms.setdefault(name, {}).setdefault(f"sq{sq}", []).append(
                        time_ms(torch, lambda: fa.flash_attention(q, k, v), 10))
                    print(name, sq, ms[name][f"sq{sq}"][-1], flush=True)
        fa._lib = own_lib
    finally:
        shutil.rmtree(out, ignore_errors=True)
    print(json.dumps({"card": card, "ms_per_round": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
