"""How closely a CUDA kernel must match its plain version on the card.

bf16 kernels: both sides round their result to bf16 from fp32 arithmetic on the same bf16
inputs, so two things separate them: the final rounding, which can land one
bf16 step apart (at most 2**-7 of the value), and the summation order. The
rule is per element,

    |got - want| <= rel * |want| + floor * rms(want),

with ``rel`` just above one bf16 step and ``floor`` a small share of the
output's own scale, so that no limit is larger than what it checks.

fp32 kernels: the flash forward computes in fp32 on the FMA units from the
same fp32 inputs as its plain version and differs from it in the
summation order, in the running maxima of the online softmax and in the last
bits of ``exp2``. The fp32 GEGLU kernel and the fp32 flash backward at
head dim 64 run their products as 3xTF32 on the tensor cores (each operand
split into two TF32 parts, the three larger of the four products summed in
fp32): as close to the exact function as an fp32 FMA sum, but in another
order than the library's fp32 product, so that two fp32-accurate answers
can lie further apart than either lies from the exact one. They are held to
their plain versions evaluated in float64 (the flash backward at every head
dim). The same rule
holds them all, with ``rel`` and ``floor`` some tens to hundreds of fp32
steps (2**-24 of the value): far below what one TF32 product (2**-11) or a
bf16 cut (2**-8) of an operand would leave.
"""

from __future__ import annotations

import torch

# flash attention: the probabilities are rounded to bf16 before the PV product
# on both sides, against running maxima that differ (64-key tiles in the
# kernel, 512-key chunks in the plain version); that noise, at most about
# 1.1 % of the output's rms at the generation path's shapes on an H100, is
# what ``floor`` covers
FLASH = {"rel": 1e-2, "floor": 2e-2}
# GEGLU: fp32 accumulation on both sides, one rounding of the product
GEGLU = {"rel": 1e-2, "floor": 1e-4}
# the fp32 kernels. Flash (FMA units, no TF32) against its fp32 plain version,
# measured on an H100 at rel = floor = 1e-4: at most 0.116 of the limit (level
# 0, 4096 keys). GEGLU (3xTF32 on the tensor cores) against its plain version
# evaluated in float64, which keeps the library's rounding out of the check:
# measured on an H100 at the rule's numbers, the kernel at most 0.79 of the
# limit (level 0), the fp32 plain version (cuBLAS, TF32 off) 2.1 (level 2)
FLASH_F32 = {"rel": 2e-5, "floor": 2e-5}
GEGLU_F32 = {"rel": 5e-6, "floor": 5e-6}


def worst_ratio(got: torch.Tensor, want: torch.Tensor, rel: float, floor: float) -> float:
    """max over elements of |got - want| / (rel |want| + floor rms(want)),
    in fp32, or in float64 where either side is; the kernel agrees with its
    plain version where this is <= 1."""
    dt = torch.promote_types(torch.promote_types(got.dtype, want.dtype), torch.float32)
    got, want = got.to(dt), want.to(dt)
    rms = want.square().mean().sqrt()
    return ((got - want).abs() / (rel * want.abs() + floor * rms)).max().item()
# the backward kernels against their plain versions (stated before their
# first run on the card). Flash: P and dS are rounded to bf16 on both sides
# from fp32 values that differ in the summation order of S, dP and Delta, and
# dS = P (dP - Delta) cancels, so a rounding that lands one bf16 step apart
# enters the sums; ``floor`` is the forward's. GEGLU gate pass: elementwise
# fp32 from the same bf16 inputs (erff against torch.erf, a few fp32 steps),
# one rounding of each result; ``floor`` covers gelu'(g) near its zero.
FLASH_BWD = {"rel": 1e-2, "floor": 2e-2}
# the fp32 flash backward against its plain version evaluated in float64 (the
# exact function; the fp32 plain version is itself a rounded answer): over up
# to 4096 keys (dq) or 2048 queries (dk, dv), with ex2.approx against
# torch.exp2 and the cancellation of dP - Delta, whose error scales with dP's
# rms and not with dS's value, which ``floor`` covers. Stated as rel = floor
# = 1e-4 for the first, FMA kernel, which read 1.68 in dk of a row with a
# single valid key, where P = 1 and dP = Delta exactly, so that dS, and the
# key's dk, are rounding noise; ``floor`` was raised to cover that noise.
# ``rel`` stays below what a TF32 cut (2**-11) of an operand would leave: the
# head-dim-64 kernel (3xTF32 on the tensor cores) measured on an H100 at most
# 0.49 of this rule (that row's dk), the fp32 plain version 0.62
FLASH_BWD_F32 = {"rel": 1e-4, "floor": 5e-4}
# the forward's row log-sum-exp (base 2, values near log2(Skv)): fp32 sums of
# the same probabilities in another order, and ex2.approx in the kernel
FLASH_LSE = {"rel": 1e-5, "floor": 1e-4}
GEGLU_BWD = {"rel": 1e-2, "floor": 1e-4}
