#!/usr/bin/env python3
"""The bf16 flash kernels at head dims 16, 32 and 128 (and 64, the
generator's), forward and backward, on one NVIDIA card.

    python3 scripts/flash_bf16_headdims.py time [--tree DIR] [--dims D ...]
    python3 scripts/flash_bf16_headdims.py ablate [--variants NAME ...] [--dims D ...]

(``chip_smoke.py --kernels`` checks every head dim against the plain
versions with ragged, empty and one-key rows.)

- ``time``: the real-work shapes (``chip_smoke.FLASH_REAL``), each the
  generator's per-call work at a width of 640 channels: (40, 2048, 4096,
  640 / D, D) and (40, 512, 1024, 640 / D, D) for D 16, 32, 128 (H 40, 20,
  5), k and v the strided halves of one merged projection, as
  ``chip_smoke.flash_real_work`` records them: forward and backward each as
  device time with the host's time kept out, CUDA events over calls issued
  back to back, the host's microseconds a call; SDPA in bf16 on the same
  inputs beside them; the bound with its terms (tensor cores, bytes,
  exponentials); the first two and the last two batch rows against the
  plain versions. ``--dims`` picks the head dims (default 16 32 128); 64
  is the generator's own levels (B 80 forward, B 40 backward; Sq 2048 /
  512 / 128, Skv 2 Sq, H 5 / 10 / 20, merged kv). ``--tree``: the root of
  the checkout whose ``panacea_tpu_torch`` is imported (default this one):
  the parent commit unpacked with ``git archive`` into an ignored
  directory times the kernels it had. Each process builds its tree's
  sources with nvcc; to compare two trees on one card, run the script for
  each in turns in one command (A, B, B, A).
- ``ablate``: the forward built from a copy of the sources with each
  variant's text changes (``VARIANTS``: ``built``, none; ``poly0``, no
  exponential on the FMA units, where ``pn::ex2_poly`` takes every 8th at
  D 16 and 32; ``mask_last``, the keys masked in the last tile alone at D
  64 too), timed at the shapes of ``time`` for ``--dims`` (default 16 32;
  64 for ``mask_last``) in turns (A, B, B, A), each checked against the
  plain versions first. ptxas's registers and spills of each variant's
  bf16 flash kernels are printed first.

The last line is one JSON object; a disagreement fails the run.
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
D64_LEVELS = ((2048, 4096, 5), (512, 1024, 10), (128, 256, 20))
SCHED, FWD = "flash_bf16_schedule.h", "flash_attention.cu"
_POLY = "PN_HOST_DEVICE constexpr int poly_every(int d) { return d < 64 ? 8 : 0; }"
_MASK = "PN_HOST_DEVICE constexpr bool fwd_mask_every_tile(int d) { return d == 64; }"
# ablate: name -> [(file, text, replacement)] of the forward's build
VARIANTS = {"built": [], "poly0": [(SCHED, _POLY, _POLY.replace("d < 64 ? 8 : 0", "0"))],
            "mask_last": [(SCHED, _MASK, _MASK.replace("d == 64", "false"))]}

_TAIL = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_longlong)] * 2 + [
    ctypes.c_float, ctypes.c_void_p]   # the entries' arguments, as ops/flash_attention.py sets them


def build_variants(cs, out: str, subs: dict) -> dict:
    """Each variant's library of the forward, built in parallel from a copy
    of the sources with its text changes: name -> ctypes.CDLL."""
    from panacea_tpu_torch.ops import _build

    procs = {}
    for name, changes in subs.items():
        vdir = os.path.join(out, name)
        shutil.copytree(_build.CSRC, vdir)
        for f, old, new in changes:
            text = open(os.path.join(vdir, f)).read()
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the text to replace is not in {f} once")
            open(os.path.join(vdir, f), "w").write(text.replace(old, new))
        procs[name] = subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", os.path.join(vdir, "lib.so"),
             os.path.join(vdir, FWD)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        for r in cs.ptxas_report(log):
            if "2wg" in r["kernel"]:
                print(json.dumps({"variant": name, **r}), flush=True)
        lib = ctypes.CDLL(os.path.join(out, name, "lib.so"))
        lib.pn_flash_attention_bf16.argtypes = [ctypes.c_void_p] * 6 + _TAIL
        lib.pn_error_string.argtypes = [ctypes.c_int]
        lib.pn_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def shapes_of(cs, dims) -> list:
    """(B, Sq, Skv, H, D, level_of) of each shape ``time`` takes at ``dims``."""
    shapes = [(b, sq, skv, cs.FLASH_REAL_WIDTH // d, d, None)
              for d in dims if d != 64 for b, sq, skv in cs.FLASH_REAL]
    if 64 in dims:
        shapes += [(b, sq, skv, h, 64, what) for sq, skv, h in D64_LEVELS
                   for b, what in ((80, "fwd"), (40, "bwd"))]
    return shapes


def ablate(torch, F, fa, tol, cs, dev, names, dims, iters) -> list:
    """Per round and variant, the forward at the shapes of ``dims``."""
    recs = []
    with tempfile.TemporaryDirectory() as out:
        libs = build_variants(cs, out, {n: VARIANTS[n] for n in names})
        for rnd, name in enumerate(list(names) + list(reversed(names))):
            fa._lib = (lambda lib=libs[name]: lib)
            for b, sq, skv, h, d, level_of in shapes_of(cs, dims):
                if level_of == "bwd":
                    continue   # the backward's batch at D 64; the variants are the forward's
                rec = cs.flash_real_work(torch, F, fa, tol, dev, b, sq, skv, h, d, iters,
                                         backward=False)
                rec.update(variant=name, round=rnd)
                print(json.dumps(rec), flush=True)
                recs.append(rec)
    return recs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("mode", choices=("time", "ablate"))
    parser.add_argument("--tree", default=ROOT, help="time: root of the checkout to import")
    parser.add_argument("--dims", nargs="+", type=int, choices=[16, 32, 64, 128],
                        help="the head dims (64: its levels); time: default 16 32 128, "
                             "ablate: 16 32")
    parser.add_argument("--variants", nargs="+", default=list(VARIANTS), choices=list(VARIANTS))
    parser.add_argument("--iters", type=int, default=10)
    args = parser.parse_args()

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("flash_bf16_headdims: no CUDA device", file=sys.stderr)
        return 2
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, ROOT)
    import chip_smoke as cs   # the timers, checks and bounds of this tree's harness
    sys.path.insert(0, tree)
    for name in [m for m in sys.modules if m.startswith("panacea_tpu_torch")]:
        del sys.modules[name]
    from panacea_tpu_torch.ops import _build
    from panacea_tpu_torch.ops import flash_attention as fa
    from panacea_tpu_torch.ops import tolerance as tol

    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    tag = "this tree" if tree == ROOT else tree
    print(json.dumps({"tree": tag, "card": card, "torch": torch.__version__}), flush=True)
    dev = torch.device("cuda")
    result = {"tree": tag, "card": card, "mode": args.mode}
    if args.mode == "ablate":
        recs = ablate(torch, F, fa, tol, cs, dev, args.variants, args.dims or [16, 32],
                      args.iters)
    else:
        _build.build_all(["flash_attention.cu", "flash_attention_bwd.cu"])
        recs = []
        for b, sq, skv, h, d, level_of in shapes_of(cs, args.dims or [16, 32, 128]):
            rec = cs.flash_real_work(torch, F, fa, tol, dev, b, sq, skv, h, d, args.iters)
            if level_of:
                rec["level_of"] = level_of
            print(json.dumps(rec), flush=True)
            recs.append(rec)
    result.update(records=recs, all_ok=all(r["ok"] for r in recs))
    print(json.dumps(result), flush=True)
    return 0 if result["all_ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
