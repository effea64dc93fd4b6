#!/usr/bin/env python3
"""Time the port's sampling path in one checkout, on one card: the bf16
forward kernels at the generation path's shapes and the direct
``log_images`` phase of ``chip_smoke.py`` (s/step, one profiled step).

    python3 scripts/sampling_step_torch.py                 # this checkout
    python3 scripts/sampling_step_torch.py --tree DIR      # another one

To compare two versions, unpack one into a directory that .gitignore lists
and run both in one call on the card, in turns (A, B, B, A): each process
imports the port of its own tree. Prints chip_smoke's JSON records.
"""

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--tree", default=ROOT, help="root of the checkout to time")
    p.add_argument("--steps", type=int, default=5)
    args = p.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))

    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("sampling_step_torch: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from panacea_tpu_torch.ops import _build
    from panacea_tpu_torch.ops import flash_attention as fa
    from panacea_tpu_torch.ops import geglu as gg
    from panacea_tpu_torch.ops import tolerance as tol

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = cs.card_line()
    cs.log({"tree": os.path.abspath(args.tree), "card": card})
    _build.build_all()
    for sq, skv, h in ((2048, 4096, 5), (512, 1024, 10), (128, 256, 20)):
        cs.check_flash(torch, F, fa, tol, dev, 80, sq, skv, h, 64, merged_kv=True)
    for tokens, c in ((196608, 320), (49152, 640), (12288, 1280), (3072, 1280)):
        cs.check_geglu(torch, F, gg, tol, dev, tokens, c)
    cs.main_path(torch, np, dev, fa, gg, args.steps, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
