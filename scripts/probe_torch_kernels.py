#!/usr/bin/env python3
"""Probe the port's CUDA kernels on one NVIDIA card, beyond what
``chip_smoke.py`` prints.

    python3 scripts/probe_torch_kernels.py [--repeat N] [--trace] [--sass]

Default: times both kernels at the main path's shapes ``--repeat`` times in
turn (``chip_smoke.check_flash`` / ``check_geglu``: the kernel, its plain
version, the library yardsticks, the bound), one JSON line per check.
``--trace`` builds the GEGLU kernel with ``-DPN_TRACE`` and prints, for the
first tiles of block 0 and both consumer warpgroups, the nanoseconds from
loop top to first full slot, to the end of the products and to the end of the
epilogue. ``--sass`` prints the opcode histogram of the GEGLU kernel's
epilogue on the TMA-store path (from the last wgmma wait to the first
UTMASTG). The compiler keeps one copy of the epilogue per bias path (paired
and scalar loads), of which a tile runs one; a copy handles a thread's 64
elements and holds 64 MUFU, which gives the number of copies.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

LEVELS = ((2048, 4096, 5), (512, 1024, 10), (128, 256, 20))
GEGLU_SHAPES = ((196608, 320), (49152, 640), (12288, 1280), (3072, 1280))


def times(torch, repeat: int) -> None:
    import torch.nn.functional as F

    import chip_smoke as cs
    from panacea_tpu_torch.ops import flash_attention as fa
    from panacea_tpu_torch.ops import geglu as gg
    from panacea_tpu_torch.ops import tolerance as tol

    dev = torch.device("cuda")
    for _ in range(repeat):
        for sq, skv, h in LEVELS:
            cs.check_flash(torch, F, fa, tol, dev, 80, sq, skv, h, 64, merged_kv=True)
        for tokens, c in GEGLU_SHAPES:
            cs.check_geglu(torch, F, gg, tol, dev, tokens, c)


def trace(torch) -> None:
    from panacea_tpu_torch.ops import _build
    from panacea_tpu_torch.ops import geglu as gg

    _build.NVCC_FLAGS.append("-DPN_TRACE")
    dev = torch.device("cuda")
    for tokens, c in GEGLU_SHAPES[:3]:
        g = torch.Generator(device=dev).manual_seed(1)
        x = torch.randn((tokens, c), generator=g, device=dev).bfloat16()
        w = (torch.randn((8 * c, c), generator=g, device=dev) * c**-0.5).bfloat16()
        b = (torch.randn(8 * c, generator=g, device=dev) * 0.1).bfloat16()
        for _ in range(3):
            gg.geglu(x, w, b)
        torch.cuda.synchronize()
        tiles, slots = 32, 4
        buf = (ctypes.c_longlong * (tiles * 2 * slots))()
        lib = gg._lib()
        lib.pn_geglu_trace.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
        _build.check(lib, lib.pn_geglu_trace(buf), "pn_geglu_trace")
        v = list(buf)
        rows = []
        for tile in range(4, 12):   # steady state: past the first fills of the ring
            for group in range(2):
                top, full, done, end = v[(tile * 2 + group) * slots:][:slots]
                rows.append({"tile": tile, "warpgroup": group, "to_first_full_ns": full - top,
                             "products_ns": done - full, "epilogue_ns": end - done})
        period = (v[11 * 2 * slots] - v[4 * 2 * slots]) / 7
        print(json.dumps({"probe": "geglu_trace", "tokens": tokens, "C": c,
                          "tile_period_ns": period, "tiles": rows}), flush=True)


def sass(torch) -> None:
    from panacea_tpu_torch.ops import _build

    _build.build_all()
    so = os.path.join(_build._build_dir(), "geglu.so")
    dump = subprocess.run([os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump"),
                           "--dump-sass", so], capture_output=True, text=True, check=True).stdout
    ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)[.\s;]", dump)
    first_store = ops.index("UTMASTG")
    wait = max(i for i, op in enumerate(ops[:first_store]) if op == "WARPGROUP")
    hist = collections.Counter(ops[wait:first_store])
    copies = max(1, hist["MUFU"] // 64)
    print(json.dumps({"probe": "geglu_epilogue_sass", "sass_ops": first_store - wait,
                      "copies": copies,
                      "per_element_of_one_copy": (first_store - wait) / copies / 64,
                      "histogram": dict(hist.most_common(16))}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repeat", type=int, default=2)
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("probe_torch_kernels: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    print(json.dumps({"probe": "env", "card": cs.card_line(), "torch": torch.__version__}))
    if args.trace:
        trace(torch)    # its own build flags: run it alone
    elif args.sass:
        sass(torch)
    else:
        times(torch, args.repeat)
    return 0


if __name__ == "__main__":
    sys.exit(main())
