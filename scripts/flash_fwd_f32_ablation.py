#!/usr/bin/env python3
"""Where the fp32 flash forwards on the tensor cores spend their time, and
the designs of the head-dim-32 one, on one NVIDIA card.

    python3 scripts/flash_fwd_f32_ablation.py [--head-dim 64|32] [--rounds N]

Builds copies of ``panacea_tpu_torch/csrc/flash_attention.cu`` (with the
headers it includes) side by side with nvcc, each with one change, and
times them in turns.

``--head-dim 64`` (the default): the fp32 kernel ``tc::pn_flash_f32_fwd_tc``
at the sampling path's levels (B 80; Sq 2048 / 512 / 128, Skv = 2 Sq, k and
v the halves of the merged kv projection), CUDA events over 10 calls.
Variants:

  base         the sources as they are;
  cvt_round    the TF32 rounding by the conversion instruction
               (cvt.rna.tf32.f32) instead of integer arithmetic on the bits
               (its results checked bit-equal to base's);
  no_split     the K and V tiles not split (wrong results, timing only);
  one_product  one TF32 product in place of three in Q K^T and P V (wrong
               results, timing only);
  no_ex2       the exponential replaced by a copy (wrong results, timing only).

``--head-dim 32``: ``tc32::pn_flash_f32_fwd_tc32``, the perception
self-attention's, at (B, 900, 1668, 8, 32) for B 1 and 2. Each variant is
checked against the plain version in float64 (``FLASH_F32``, and the row
log-sum-exp under ``FLASH_LSE``) and timed three ways: the device time of
one call (the calls queued behind a kernel that sleeps, so that the host's
time does not enter; ``chip_smoke.queued_ms`` over 20 calls), CUDA events
over 20 calls issued back to back (``chip_smoke.time_ms``, the ``ms`` of
chip_smoke's records, which carries the host's time where a call takes
longer to issue than to run), and the host's time per call
(``chip_smoke.host_us`` over 200 calls). Variants:

  base         the sources as they are (32-key tiles, a cluster of two
               blocks splitting the keys where twice the blocks fit one
               wave, the device and its SM count queried on every call);
  kt64         64-key tiles;
  no_split     every block walks all its row's keys (64 blocks at B 1);
  split        the keys always split over a cluster of two (256 blocks at B 2);
  fma          the FMA kernel that served head dim 32 before
               (``f32::pn_flash_f32_fwd<32>``);
  no_query     neither query (132 SMs taken as given);
  no_cluster   no cluster attribute on the launch where the keys are not
               split (base gives one of a single block);

and, to see where base's time goes (wrong results, timed only):
``no_kv_split``, ``one_product``, ``no_ex2``, as at head dim 64.

ptxas's register report and advisories (C75xx: serialised wgmma) are printed
per variant. The last line is one JSON object; at head dim 32 the run fails
if a variant whose results are the kernel's function disagrees with float64.
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
SOURCES = ("flash_attention.cu", "hopper.cuh", "flash_f32_tc.cuh", "flash_f32_tc32_schedule.h",
           "flash_bf16_schedule.h")
CU, CUH, SCHED = "flash_attention.cu", "flash_f32_tc.cuh", "flash_f32_tc32_schedule.h"
INT_ROUND = "  return __uint_as_float((__float_as_uint(a) + 0x1000u) & 0xFFFFE000u);"
CVT_ROUND = """  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(r) : "f"(a));
  return __uint_as_float(r & 0xFFFFE000u);"""
SPLIT = ("    split_tile<D, T, false, true, 8>(sl.k, sl.k_small, nullptr, nullptr, "
         "threadIdx.x >> 5, lane);\n"
         "    split_tile<D, T, true, false, 8>(sl.v, nullptr, sl.vt[0], sl.vt[1], "
         "threadIdx.x >> 5, lane);\n")
SPLIT32 = """      split_tile<D, KT, false, true, 8>(sl.k, sl.k_small, nullptr, nullptr, threadIdx.x >> 5,
                                        lane);
      split_tile<D, KT, true, false, 8>(sl.v, nullptr, sl.vt[0], sl.vt[1], threadIdx.x >> 5,
                                        lane);
"""
S3 = """    mma_rs(set, a_small[kk], smem_desc(b_big + bo), kk % PER_SET != 0);
    mma_rs(set, a_big[kk], smem_desc(b_small + bo), 1);
    mma_rs(set, a_big[kk], smem_desc(b_big + bo), 1);"""
S1 = "    mma_rs(set, a_big[kk], smem_desc(b_big + bo), kk % PER_SET != 0);"
PV3 = """    mma_rs(acc, a_small[kk], smem_desc(b_big + bo), kk > 0);
    mma_rs(acc, a_big[kk], smem_desc(b_small + bo), 1);
    mma_rs(acc, a_big[kk], smem_desc(b_big + bo), 1);"""
PV1 = "    mma_rs(acc, a_big[kk], smem_desc(b_big + bo), kk > 0);"
ONE_PRODUCT = [(CUH, S3, S1), (CUH, PV3, PV1)]
EX2 = "\n      s[i] = wg::ex2(s[i] - m[(i >> 1) & 1]);"   # tc's (tc32's is indented more)
EX2_32 = "        s[i] = wg::ex2(s[i] - m[(i >> 1) & 1]);\n"
KT32, KT64 = "constexpr int KT = 32;", "constexpr int KT = 64;"
SPLIT_RULE = "SPLIT * blocks <= sms ? SPLIT : 1"
FMA = ("    case 32: return tc32::launch(q, k, v, o, lse, kv_lens, batch, heads, sq, skv, "
       "strides, scale_log2, s);",
       "    case 32: return f32::launch<32>(q, k, v, o, lse, kv_lens, batch, heads, sq, skv, "
       "strides, scale_log2, s);")
QUERY = """  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
"""
ATTRS = "  cfg.numAttrs = 1;\n  err = cudaLaunchKernelEx(&cfg, pn_flash_f32_fwd_tc32"
# head dim -> {name: [(file, old text, new text)]}
VARIANTS = {
    64: {"base": [], "cvt_round": [("hopper.cuh", INT_ROUND, CVT_ROUND)],
         "no_split": [(CU, SPLIT, "")], "one_product": ONE_PRODUCT,
         "no_ex2": [(CU, EX2, "\n      s[i] = s[i] - m[(i >> 1) & 1];")]},
    32: {"base": [], "kt64": [(SCHED, KT32, KT64)], "no_split": [(SCHED, SPLIT_RULE, "1")],
         "split": [(SCHED, SPLIT_RULE, "SPLIT")], "fma": [(CU, *FMA)],
         "no_query": [(CU, QUERY, "  int sms = 132;\n  cudaError_t err = cudaSuccess;\n")],
         "no_cluster": [(CU, ATTRS, ATTRS.replace("= 1;", "= split > 1;"))],
         "no_kv_split": [(CU, SPLIT32, "")], "one_product": ONE_PRODUCT,
         "no_ex2": [(CU, EX2_32, "        s[i] = s[i] - m[(i >> 1) & 1];\n")]}}
EXACT = ("base", "cvt_round")   # head dim 64: variants whose results are the kernel's
TIMED_ONLY = ("no_kv_split", "one_product", "no_ex2")   # head dim 32: wrong results
KERNEL = {64: ("pn_flash_f32_fwd_tc",), 32: ("pn_flash_f32_fwd_tc32", "pn_flash_f32_fwdILi32")}
LEVELS = ((2048, 4096, 5), (512, 1024, 10), (128, 256, 20))
SHAPES = ((1, 900, 1668, 8, 32), (2, 900, 1668, 8, 32))


def build(out: str, d: int) -> dict:
    """Every variant's library at head dim ``d``, built in parallel: name ->
    ctypes.CDLL."""
    from panacea_tpu_torch.ops import _build

    procs = {}
    for name, subs in VARIANTS[d].items():
        vdir = os.path.join(out, name)
        os.makedirs(vdir)
        for f in SOURCES:
            with open(os.path.join(_build.CSRC, f)) as fh:
                text = fh.read()
            for target, old, new in subs:
                if target == f:
                    if text.count(old) != 1:
                        raise RuntimeError(f"{name}: the text to replace is not in {f} once")
                    text = text.replace(old, new)
            with open(os.path.join(vdir, f), "w") as fh:
                fh.write(text)
        procs[name] = subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", os.path.join(vdir, "lib.so"),
             os.path.join(vdir, "flash_attention.cu")],
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
            if any(k in line for k in KERNEL[d]):   # its spill and register lines follow
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


def run_d64(torch, fa, libs, rounds, dev) -> dict:
    """{variant: {level: [ms per round]}} at head dim 64."""
    from chip_smoke import time_ms

    ms: dict = {}
    base_out = {}
    for rnd in range(rounds):
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
    return {"ms_per_round": ms}


def run_d32(torch, fa, libs, rounds, dev) -> dict:
    """Per variant and shape: device ms, events ms and host us per round,
    and the worst ratios (out, lse) against float64, at head dim 32."""
    from chip_smoke import host_us, queued_ms, time_ms
    from panacea_tpu_torch.ops import tolerance as tol

    inputs = []
    for b, sq, skv, h, d in SHAPES:
        g = torch.Generator(device=dev).manual_seed(sq * 7 + skv + d)
        q, k, v = (torch.randn((b, n, h, d), generator=g, device=dev) for n in (sq, skv, skv))
        want = fa.flash_attention_plain(q.double(), k.double(), v.double(), return_lse=True)
        inputs.append((q, k, v, want))
    times: dict = {}
    ratios: dict = {}
    for rnd in range(rounds):
        for name, lib in libs.items():
            fa._lib = lambda lib=lib: lib
            for (q, k, v, want), shape in zip(inputs, SHAPES):
                key = f"b{shape[0]}"
                if rnd == 0:
                    got, lse = fa.flash_attention_with_lse(q, k, v)
                    ratios.setdefault(name, {})[key] = (
                        tol.worst_ratio(got, want[0], **tol.FLASH_F32),
                        tol.worst_ratio(lse, want[1], **tol.FLASH_LSE))

                def call(q=q, k=k, v=v):
                    fa.flash_attention(q, k, v)

                t = times.setdefault(name, {}).setdefault(
                    key, {"ms_device": [], "ms_events": [], "host_us": []})
                t["ms_device"].append(queued_ms(torch, call, 20))
                t["ms_events"].append(time_ms(torch, call, 20))
                t["host_us"].append(host_us(torch, call, 200))
                print(name, key, {n: x[-1] for n, x in t.items()}, ratios[name][key], flush=True)
    bad = {n: r for n, r in ratios.items()
           if n not in TIMED_ONLY and max(max(x) for x in r.values()) > 1.0}
    return {"per_round": times, "worst_ratio_out_lse": ratios, "failed": bad}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("flash_fwd_f32_ablation: no CUDA device", file=sys.stderr)
        return 2
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--head-dim", type=int, choices=(64, 32), default=64)
    parser.add_argument("--rounds", type=int, default=2)
    args = parser.parse_args()
    sys.path.insert(0, ROOT)
    from panacea_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda")
    out = tempfile.mkdtemp(prefix="flash_fwd_f32_ablation_")
    own_lib = fa._lib
    try:
        libs = build(out, args.head_dim)
        run = run_d64 if args.head_dim == 64 else run_d32
        result = run(torch, fa, libs, args.rounds, dev)
    finally:
        fa._lib = own_lib
        shutil.rmtree(out, ignore_errors=True)
    print(json.dumps({"card": card, "head_dim": args.head_dim, **result}), flush=True)
    return 1 if result.get("failed") else 0


if __name__ == "__main__":
    sys.exit(main())
