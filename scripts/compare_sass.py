#!/usr/bin/env python3
"""The machine code of the fp32 flash kernels, on a machine with the CUDA
toolkit.

    python3 scripts/compare_sass.py [--other DIR] [--kernel NAME ...]
                                    [--pair MINE OTHER ...]

Builds ``csrc/flash_attention.cu`` and ``csrc/flash_attention_bwd.cu`` of
this tree with nvcc (the flags of ``ops/_build.py``), dumps their SASS with
cuobjdump and:

- with ``--other``, the root of another checkout (for example the parent
  commit unpacked with ``git archive``): builds its two sources the same
  way and says, for every fp32 kernel (``f32`` in its name), whether
  its SASS is the same instruction for instruction in both trees; and
  with ``--pair MINE OTHER`` (repeatable), the same for the first kernel
  of this tree whose name contains MINE against the first of the other
  whose name contains OTHER, for a kernel whose name changed (the bf16
  ``pn_flash_fwd``, now ``pn_flash_fwd<64>``: ``--pair
  pn_flash_fwdILi64E wg12pn_flash_fwdE``);
- for the first kernel whose name contains each ``--kernel`` (default
  ``tc32``, the fp32 forward at head dim 32; ``dkdv_tc32`` and ``dq_tc32``
  are the passes of its backward), finds its main loop (the longest
  backward branch; the mbarrier waits are loops of a few instructions) and
  prints the loop's instruction count and the count of each opcode. The
  tc32 forward's loop is unrolled by two: its body runs two key tiles.

The last line is one JSON object.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = ("flash_attention.cu", "flash_attention_bwd.cu")


def build_sass(root: str, out: str) -> dict:
    """{kernel name without its file's anonymous-namespace hash: [(address,
    instruction)]} of the two sources under ``root``."""
    sys.path.insert(0, ROOT)
    from panacea_tpu_torch.ops import _build

    nvcc = _build.find_nvcc()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    procs = []
    for src in SOURCES:
        lib = os.path.join(out, src.replace(".cu", ".so"))
        procs.append((lib, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-o", lib,
             os.path.join(root, "panacea_tpu_torch", "csrc", src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    funcs: dict = {}
    for lib, p in procs:
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed on {lib}:\n{log}")
        text = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True,
                              check=True).stdout
        name = None
        for line in text.splitlines():
            m = re.match(r"\s+Function : (\S+)", line)
            if m:
                name = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__", m.group(1))
                funcs[name] = []
                continue
            m = re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
            if m and name:
                funcs[name].append((int(m.group(1), 16), m.group(2)))
    return funcs


def main_loop(code: list) -> list:
    """The instructions of the longest backward branch's range (the waits
    on mbarriers are loops of a few instructions)."""
    best = []
    for addr, ins in code:
        m = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", ins)
        if m and int(m.group(1), 16) < addr:
            body = [i for a, i in code if int(m.group(1), 16) <= a <= addr]
            best = max(best, body, key=len)
    return best


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--other", help="root of another checkout to compare with")
    parser.add_argument("--kernel", nargs="+", default=["tc32"])
    parser.add_argument("--pair", nargs=2, action="append", default=[],
                        metavar=("MINE", "OTHER"))
    args = parser.parse_args()
    out = tempfile.mkdtemp(prefix="compare_sass_")
    result: dict = {}
    try:
        for d in ("mine", "other"):
            os.makedirs(os.path.join(out, d))
        mine = build_sass(ROOT, os.path.join(out, "mine"))
        if args.other:
            other = build_sass(os.path.abspath(args.other), os.path.join(out, "other"))
            same = {}
            for name in sorted(set(mine) | set(other)):
                if "f32" not in name:
                    continue
                if name in mine and name in other:
                    same[name] = ([i for _, i in mine[name]] == [i for _, i in other[name]])
                else:
                    same[name] = "only in " + ("this tree" if name in mine else "the other")
                print(f"{name}: {same[name]}", flush=True)
            result["same_sass"] = same
            pairs = {}
            for a, b in args.pair:
                na = next((n for n in mine if a in n), None)
                nb = next((n for n in other if b in n), None)
                pairs[f"{a} = {b}"] = (
                    [i for _, i in mine[na]] == [i for _, i in other[nb]]
                    if na and nb else f"not found: {a if not na else b}")
                print(f"{na} against {nb}: {pairs[f'{a} = {b}']}", flush=True)
            if pairs:
                result["same_sass_pairs"] = pairs
        for pattern in args.kernel:
            name = next((n for n in mine if pattern in n), None)
            if not name:
                continue
            loop = main_loop(mine[name])
            ops = collections.Counter(re.sub(r"^@!?U?P[T0-9]+\s+", "", i).split()[0].split(".")[0]
                                      for i in loop)
            result.setdefault("kernels", {})[name] = {
                "instructions": len(mine[name]), "main_loop_instructions": len(loop),
                "main_loop_opcodes": dict(ops.most_common())}
            print(f"{name}: {len(mine[name])} instructions, main loop {len(loop)}", flush=True)
            for op, n in ops.most_common():
                print(f"  {op:12s}{n}", flush=True)
    finally:
        shutil.rmtree(out, ignore_errors=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
