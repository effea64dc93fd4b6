"""What one clip over several ranks exchanges (counterpart of
``panacea_tpu/parallel/hlo_report.py``).

The JAX package reads the collectives of its sharded sampler from the
compiled program's HLO, split into "per-step" (inside the sampler's loop,
once a denoiser evaluation) and "once" (set-up and epilogue). The port
issues each collective itself (``parallel/shardctx.py``), so it counts them
as they run: by kind, with the bytes this rank hands to the collective (its
send buffers: both halves of a halo, the partial sums of a statistic, the
whole buffer of an all-to-all or a gather) and the host milliseconds of the
call. Under gloo with CUDA tensors the card is synchronised before the
clock starts, so those milliseconds are the host copies and the transfer;
under NCCL they are the enqueueing only. ``evaluation()`` marks one
denoiser evaluation; what runs outside it counts as once a clip.

A training step over the grid (``training_step()``) splits its exchanges
by direction: the forward pass, the forward that ``torch.utils.checkpoint``
recomputes inside the backward (``recompute()``, entered by
``shardctx.checkpoint_contexts``) and the backward passes, whose kinds end
in ``_bwd`` wherever they run (on the card, autograd's own thread).

Kinds: ``halo_w`` (a column a side, the convolutions), ``halo_t`` (a frame
a side, the temporal convolutions), ``stats_view`` and ``stats_t`` (the
GroupNorm and TemporalGroupNorm sums), ``all_to_all`` (the temporal stage),
``ring`` (the cross-view boundary K/V), ``gather_view`` (K/V of stage 1's
'full' mode) and ``gather`` (the clip's latents and decoded frames); the
backward passes ``halo_t_bwd``, ``stats_t_bwd`` and ``all_to_all_bwd``.
The sharded training state (``parallel/fsdp.py``, ``--fsdp``) adds
``fsdp_gather`` (a unit's parameters, or the first stage's, all-gathered
before it runs, forward or recomputed), ``fsdp_reduce_scatter_bwd`` (a
unit's fp32 gradients, each rank receiving its slices), ``fsdp_norm`` (the
clip's squared norm, summed over the ranks after the backward, counted
"once") and ``fsdp_state`` (a checkpoint's whole tensors gathered a bucket
at a time). Their bytes are this rank's send buffer: its slices for a
gather, the whole fp32 buffer for a reduce-scatter.
"""

from __future__ import annotations

import contextlib
import contextvars
from collections import defaultdict
from typing import Any, Dict

KINDS = ("halo_w", "halo_t", "stats_view", "stats_t", "all_to_all", "ring", "gather_view",
         "gather", "halo_t_bwd", "stats_t_bwd", "all_to_all_bwd", "fsdp_gather",
         "fsdp_reduce_scatter_bwd", "fsdp_norm", "fsdp_state")
# the phases of a training step, by direction
STEP_PHASES = ("forward", "recompute", "backward")

_PHASE: contextvars.ContextVar = contextvars.ContextVar("panacea_comm_phase", default="once")
_counts: Dict[tuple, list] = defaultdict(lambda: [0, 0, 0.0])
_evals, _steps = [0], [0]


def reset() -> None:
    _counts.clear()
    _evals[0] = _steps[0] = 0


def record(kind: str, nbytes: int, seconds: float) -> None:
    """One collective of ``kind`` that handed over ``nbytes`` in ``seconds``."""
    if kind not in KINDS:
        raise ValueError(f"unknown exchange kind {kind!r}")
    phase = "backward" if kind.endswith("_bwd") else _PHASE.get()
    entry = _counts[(phase, kind)]
    entry[0] += 1
    entry[1] += int(nbytes)
    entry[2] += seconds


@contextlib.contextmanager
def evaluation():
    """One denoiser evaluation: its exchanges count as per evaluation."""
    _evals[0] += 1
    token = _PHASE.set("per_eval")
    try:
        yield
    finally:
        _PHASE.reset(token)


@contextlib.contextmanager
def training_step():
    """One training step: its forward exchanges count as such."""
    _steps[0] += 1
    token = _PHASE.set("forward")
    try:
        yield
    finally:
        _PHASE.reset(token)


@contextlib.contextmanager
def recompute():
    """The forward that checkpointing recomputes inside the backward."""
    token = _PHASE.set("recompute")
    try:
        yield
    finally:
        _PHASE.reset(token)


def summary() -> Dict[str, Any]:
    """``per_eval``: each kind's calls, MiB and host ms for one denoiser
    evaluation (the mean over ``evals``); ``once``: the totals outside
    the evaluations and steps; ``forward``, ``recompute`` and
    ``backward``: a training step's, the mean over ``steps``; and
    ``<phase>_total`` of each over its kinds."""
    div = {"per_eval": max(_evals[0], 1), "once": 1}
    div.update((p, max(_steps[0], 1)) for p in STEP_PHASES)
    out: Dict[str, Any] = {"evals": _evals[0], "steps": _steps[0]}
    out.update((p, {}) for p in div)
    for (phase, kind), (calls, nbytes, secs) in sorted(_counts.items()):
        n = div[phase]
        out[phase][kind] = {"calls": calls / n, "MiB": nbytes / n / 2**20, "ms": 1e3 * secs / n}
    for phase in div:
        rows = out[phase].values()
        out[f"{phase}_total"] = {k: sum(r[k] for r in rows) for k in ("calls", "MiB", "ms")}
    return out


def format_report(s: Dict[str, Any]) -> str:
    lines = [f"  exchanges over {s['evals']} denoiser evaluations and {s['steps']} training "
             "steps (calls / MiB / host ms):"]
    labels = (("per_eval", "per evaluation"), ("once", "once"),
              ("forward", "a step, forward"), ("recompute", "a step, recomputed"),
              ("backward", "a step, backward"))
    for phase, label in labels:
        if phase != "once" and not s[phase]:
            continue
        for kind, r in s[phase].items():
            lines.append(f"    {label:20s} {kind:14s} x{r['calls']:<8.1f} {r['MiB']:10.2f} MiB "
                         f"{r['ms']:10.2f} ms")
        t = s[f"{phase}_total"]
        lines.append(f"    {label:20s} {'total':14s} x{t['calls']:<8.1f} {t['MiB']:10.2f} MiB "
                     f"{t['ms']:10.2f} ms")
    return "\n".join(lines)
