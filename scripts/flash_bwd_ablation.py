#!/usr/bin/env python3
"""Where the flash backward on the tensor cores spends its time, and the
designs of the fp32 one at head dim 32, on one NVIDIA card.

    python3 scripts/flash_bwd_ablation.py [--head-dim 64|32] [--rounds N]

Builds copies of ``panacea_tpu_torch/csrc/flash_attention_bwd.cu`` (with the
headers it includes) side by side with nvcc, each with one change, and
times them in turns.

``--head-dim 64`` (the default): the bf16 wgmma route at the training
levels (B 40; Sq 2048 / 512 / 128, Skv = 2 Sq), each pass (Delta, dK/dV,
dQ) as device time under torch.profiler. Variants:

  base      the source as it is;
  int_pack  the bf16 rounding of P and dS done with integer arithmetic
            instead of the conversion instruction (the same results; checked
            against the plain version);
  no_ex2    the exponential replaced by a copy (wrong results, timing only).

``--head-dim 32``: the fp32 backward ``tc32::pn_flash_bwd_f32_{dkdv,dq}_tc32``,
the perception training's (SparseHead's grad frame without DN), at
(B, 900, 1668, 8, 32) for B 1 and 2. Each variant whose results are the
kernel's function is checked against the plain version in float64
(``FLASH_BWD_F32``, dq, dk and dv) and every variant is timed three ways:
the device time of one call (the calls queued behind a kernel that sleeps,
so that the host's time does not enter; ``chip_smoke.queued_ms`` over 20
calls), CUDA events over 20 calls issued back to back
(``chip_smoke.time_ms``) and the host's time per call
(``chip_smoke.host_us`` over 200 calls). Variants:

  base        the sources as they are (dK/dV: 64 keys a block of one
              warpgroup, two blocks an SM, K and V split in registers,
              two ring slots; dQ: 64 query rows a block of two
              warpgroups that take the key tiles in turn, two ring slots
              each; S in one accumulator set; the passes one after the
              other on the caller's stream);
  kv_stages3  three ring slots in the dK/dV pass;
  dq_dp8      dP of the dQ pass in accumulator sets of 8 channels, as the
              dK/dV pass has them;
  fma         the FMA kernels that served head dim 32 before
              (``f32::pn_flash_bwd_f32_{dkdv,dq}<32>``);

and, to split the time by pass (wrong results, timed only):
``delta_only`` (the launch returns after the Delta pre-pass) and ``no_dq``
(after the dK/dV pass): Delta = delta_only, dK/dV = no_dq - delta_only,
dQ = base - no_dq, each a median of the queued device times. Each variant's kernels are also read under
torch.profiler (CUDA activity only, 5 calls), first in a process that has
run no profiler session with host activity, then again after one such
session (as ``chip_smoke.profile_step`` runs), to see whether the profiler
sees the kernels in either case.

ptxas's register report and advisories (C75xx: serialised wgmma) are printed
per variant, since a serialised variant times something else. The last line
is one JSON object; at head dim 32 the run fails if a variant whose results
are the kernel's function disagrees with float64.
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
SOURCES = ("flash_attention_bwd.cu", "hopper.cuh", "flash_f32_tc.cuh",
           "flash_f32_tc32_bwd_schedule.h", "flash_bf16_schedule.h")
CU = "flash_attention_bwd.cu"
EX2 = 'asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));'
PACK = """  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);"""
INT_PACK = """  uint32_t a = __float_as_uint(lo), b = __float_as_uint(hi);
  a += 0x7fffu + ((a >> 16) & 1u);
  b += 0x7fffu + ((b >> 16) & 1u);
  return __byte_perm(a, b, 0x7632);"""
FMA = ("    case 32: return tc32::launch(q, k, v, o, d_o, lse, delta, dq, dk, dv, kv_lens, "
       "batch, heads, sq, skv, strides, scale, s);",
       "    case 32: return f32::launch<32>(q, k, v, o, d_o, lse, delta, dq, dk, dv, kv_lens, "
       "batch, heads, sq, skv, strides, scale, s);")
# tc32::launch's returns after the Delta launch and after the dK/dV launch
AFTER_DELTA = "  if (err) return err;\n  pn_flash_bwd_f32_dkdv_tc32<<<"
AFTER_DKDV = "  if (err) return err;\n  pn_flash_bwd_f32_dq_tc32<<<"
# head dim -> {name: [(file, old text, new text)]}
VARIANTS = {
    64: {"base": [], "int_pack": [("hopper.cuh", PACK, INT_PACK)],
         "no_ex2": [(CU, EX2, "y = x;")]},
    32: {"base": [],
         "kv_stages3": [(CU, "KV_STAGES = 2, Q_STAGES = 2;", "KV_STAGES = 3, Q_STAGES = 2;")],
         "fma": [(CU, *FMA)],
         "dq_dp8": [(CU, "Q_DP_SETS = D / 16;", "Q_DP_SETS = D / 8;")],
         "delta_only": [(CU, AFTER_DELTA, AFTER_DELTA.replace("if (err) ", ""))],
         "no_dq": [(CU, AFTER_DKDV, AFTER_DKDV.replace("if (err) ", ""))]}}
TIMED_ONLY = ("delta_only", "no_dq")   # head dim 32: wrong results
KERNEL = {64: ("pn_flash_bwd_dkdv_wg", "pn_flash_bwd_dq_wg"),
          32: ("pn_flash_bwd_f32_dkdv_tc32", "pn_flash_bwd_f32_dq_tc32",
               "pn_flash_bwd_f32_dkdvILi32", "pn_flash_bwd_f32_dqILi32")}
LEVELS = ((2048, 4096, 5), (512, 1024, 10), (128, 256, 20))
PASSES = (("delta", "bwd_delta"), ("dkdv", "dkdv_wg"), ("dq", "dq_wg"))
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
             os.path.join(vdir, CU)],
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
                        print(f"{name} ptxas: {line.strip()[-60:]} {after.strip()[:120]}",
                              flush=True)
        lib = ctypes.CDLL(os.path.join(out, name, "lib.so"))
        lib.pn_error_string.argtypes = [ctypes.c_int]
        lib.pn_error_string.restype = ctypes.c_char_p
        for entry in (lib.pn_flash_attention_bwd_bf16, lib.pn_flash_attention_bwd_f32):
            entry.argtypes = (
                [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5
                + [ctypes.POINTER(ctypes.c_longlong)] * 2 + [ctypes.c_float, ctypes.c_void_p])
            entry.restype = ctypes.c_int
        libs[name] = lib
    return libs


def run_d64(torch, fa, libs, rounds, dev) -> dict:
    """{variant: {pass_level: [device ms per round]}} at head dim 64."""
    from torch.profiler import ProfilerActivity, profile

    from panacea_tpu_torch.ops import tolerance as tol

    ms: dict = {}
    for rnd in range(rounds):
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
    return {"ms_device_per_round": ms}


def profiled(torch, call, calls: int = 5) -> dict:
    """{kernel name: device ms a call} that torch.profiler (CUDA activity
    only) records over ``calls`` calls, after one warm-up; with
    ``device_type`` beside each, as ``chip_smoke.device_ms`` filters on it."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    return {evt.key[:90]: [(getattr(evt, "self_device_time_total", 0.0) or 0.0) / 1e3 / calls,
                           str(evt.device_type)]
            for evt in prof.key_averages()}


def run_d32(torch, fa, libs, rounds, dev) -> dict:
    """Per variant and shape: device ms, events ms and host us per round,
    the worst ratios (dq, dk, dv) against float64, each pass's share, and
    what torch.profiler sees, at head dim 32."""
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import host_us, queued_ms, time_ms
    from panacea_tpu_torch.ops import tolerance as tol

    inputs = []
    for b, sq, skv, h, d in SHAPES:
        g = torch.Generator(device=dev).manual_seed(sq * 5 + skv + d)
        q, k, v, do = (torch.randn((b, n, h, d), generator=g, device=dev)
                       for n in (sq, skv, skv, sq))
        o, lse = fa.flash_attention_with_lse(q, k, v)
        want = fa.flash_attention_bwd_plain(*(t.double() for t in (q, k, v, o, lse, do)))
        inputs.append((q, k, v, o, lse, do, want))
    times: dict = {}
    ratios: dict = {}
    seen: dict = {}
    for rnd in range(rounds):
        for name, lib in libs.items():
            fa._bwd_lib = lambda lib=lib: lib
            for (q, k, v, o, lse, do, want), shape in zip(inputs, SHAPES):
                key = f"b{shape[0]}"

                def call(q=q, k=k, v=v, o=o, lse=lse, do=do):
                    fa.flash_attention_bwd(q, k, v, o, lse, do)

                if rnd == 0:
                    if name not in TIMED_ONLY:
                        got = fa.flash_attention_bwd(q, k, v, o, lse, do)
                        ratios.setdefault(name, {})[key] = [
                            tol.worst_ratio(a, w, **tol.FLASH_BWD_F32) for a, w in zip(got, want)]
                        del got
                    seen.setdefault("before_host_trace", {}).setdefault(name, {})[key] = (
                        profiled(torch, call))
                t = times.setdefault(name, {}).setdefault(
                    key, {"ms_device": [], "ms_events": [], "host_us": []})
                t["ms_device"].append(queued_ms(torch, call, 20))
                t["ms_events"].append(time_ms(torch, call, 20))
                t["host_us"].append(host_us(torch, call, 200))
                print(name, key, {n: x[-1] for n, x in t.items()}, ratios.get(name, {}).get(key),
                      flush=True)
    # one profiler session with host activity, as chip_smoke.profile_step
    # runs, then the CUDA-only reading again
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        fa._bwd_lib = lambda lib=libs["base"]: lib
        call()
        torch.cuda.synchronize()
    for name in ("base", "fma"):
        fa._bwd_lib = lambda lib=libs[name]: lib
        seen.setdefault("after_host_trace", {})[name] = profiled(torch, call)
    med = {n: {s: sorted(x["ms_device"])[len(x["ms_device"]) // 2] for s, x in per.items()}
           for n, per in times.items()}
    passes = {s: {"delta": med["delta_only"][s], "dkdv": med["no_dq"][s] - med["delta_only"][s],
                  "dq": med["base"][s] - med["no_dq"][s]} for s in med["base"]}
    bad = {n: r for n, r in ratios.items() if max(max(x) for x in r.values()) > 1.0}
    return {"per_round": times, "median_ms_device": med, "passes_ms_device": passes,
            "worst_ratio_dq_dk_dv": ratios, "profiler": seen, "failed": bad}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("flash_bwd_ablation: no CUDA device", file=sys.stderr)
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
    out = tempfile.mkdtemp(prefix="flash_bwd_ablation_")
    own_lib = fa._bwd_lib
    try:
        libs = build(out, args.head_dim)
        run = run_d64 if args.head_dim == 64 else run_d32
        result = run(torch, fa, libs, args.rounds, dev)
    finally:
        fa._bwd_lib = own_lib
        shutil.rmtree(out, ignore_errors=True)
    print(json.dumps({"card": card, "head_dim": args.head_dim, **result}), flush=True)
    return 1 if result.get("failed") else 0


if __name__ == "__main__":
    sys.exit(main())
