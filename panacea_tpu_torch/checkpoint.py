"""Loading a reference checkpoint into the port's engine.

The port's parameter names are the reference checkpoint's own, so there is no
key map: a ``.ckpt`` is read with ``torch.load``, unwrapped
(``panacea_tpu/utils/convert.py:403-415``), its EMA shadows are swapped in
where asked (``:418-446``), and ``engine.load_state_dict(strict=True)`` takes
the rest. ``dry_convert`` is the name-and-shape check of a key list or a
checkpoint against the engine built on the meta device (the JAX CLI's
``--dry_convert`` drill).
"""

from __future__ import annotations

import json
from typing import Any, Dict, Mapping, Tuple

import torch

from panacea_tpu_torch.models.engine import is_non_weight

_EMA_COUNTERS = ("model_ema.decay", "model_ema.num_updates")
CHECKPOINT_SUFFIXES = (".ckpt", ".pth")


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A Lightning/DeepSpeed ``.ckpt`` as a flat state dict on the CPU: the
    ``state_dict`` entry where there is one, DeepSpeed's ``_forward_module.``
    wrapper prefix removed (reference inference.py:207-218). The file is
    unpickled in full, as such checkpoints hold more than tensors: load only
    files you trust."""
    if path.endswith(".safetensors"):
        raise ValueError(f"{path}: reading .safetensors is not ported; give the .ckpt")
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(sd, Mapping) and "state_dict" in sd:
        sd = sd["state_dict"]
    if not isinstance(sd, Mapping):
        raise ValueError(f"{path}: expected a state dict, got {type(sd).__name__}")
    return {k.replace("_forward_module.", ""): torch.as_tensor(v) for k, v in sd.items()}


def has_ema_weights(sd: Mapping[str, Any]) -> bool:
    return any(k.startswith("model_ema.") and k not in _EMA_COUNTERS for k in sd)


def apply_ema_weights(sd: Mapping[str, torch.Tensor]) -> Tuple[Dict[str, torch.Tensor], int]:
    """Substitute ``model.*`` weights with their EMA shadows.

    The reference LitEma registers one buffer per trainable parameter, named
    by stripping every '.' from the parameter's name (ema.py:5-26), under the
    ``model_ema.`` prefix: ``model.X`` has the shadow ``model_ema.<X without
    dots>``. Returns the substituted dict and the number of swapped tensors."""
    out = dict(sd)
    n = 0
    for key in sd:
        if not key.startswith("model."):
            continue
        shadow = "model_ema." + key[len("model."):].replace(".", "")
        if shadow in sd and sd[shadow].shape == sd[key].shape:
            out[key] = sd[shadow]
            n += 1
    return out, n


def load_checkpoint(path_or_sd, engine, prefer_ema: bool = False) -> Dict[str, Any]:
    """Load a reference checkpoint (a path, or a state dict already read)
    into ``engine`` with ``strict=True``: a missing or unknown name raises.
    ``prefer_ema`` loads the ``model_ema.*`` shadows in place of the raw
    ``model.*`` weights and raises where the checkpoint has none. Returns a
    report of what was loaded."""
    sd = load_torch_checkpoint(path_or_sd) if isinstance(path_or_sd, str) else dict(path_or_sd)
    ema_available = has_ema_weights(sd)
    swapped = 0
    if prefer_ema:
        if not ema_available:
            raise ValueError("prefer_ema=True but the checkpoint has no model_ema.* shadows")
        sd, swapped = apply_ema_weights(sd)
    engine.load_state_dict(sd, strict=True)
    return {"loaded": sum(not is_non_weight(k) for k in sd), "total_keys": len(sd),
            "ema_available": ema_available, "ema_swapped": swapped,
            "weights": "ema" if prefer_ema else "raw"}


def check_coverage(key_shapes: Mapping[str, Any], engine) -> Dict[str, Any]:
    """Hold a checkpoint's names and shapes against ``engine``'s parameters.
    ``unmapped``: checkpoint keys the engine has no parameter for (and that
    are not known non-weights); ``missing``: engine parameters the checkpoint
    lacks; ``shape_mismatch``: (key, checkpoint shape, engine shape)."""
    want = {k: tuple(v.shape) for k, v in engine.state_dict().items()}
    unmapped, mismatch, checked = [], [], 0
    for key, shape in key_shapes.items():
        if key in want:
            checked += 1
            if tuple(shape) != want[key]:
                mismatch.append((key, tuple(shape), want[key]))
        elif not is_non_weight(key):
            unmapped.append(key)
    missing = [k for k in want if k not in key_shapes]
    return {"total_keys": len(key_shapes), "checked": checked, "unmapped": unmapped,
            "missing": missing, "shape_mismatch": mismatch}


def dry_convert(engine, key_source: str) -> int:
    """Print the coverage report of ``key_source`` (a json ``{key: shape}``
    list, or a checkpoint) against ``engine`` as one JSON line, the items at
    fault after it; a process exit code."""
    if key_source.endswith(CHECKPOINT_SUFFIXES):
        key_shapes = {k: list(v.shape) for k, v in load_torch_checkpoint(key_source).items()}
    else:
        with open(key_source) as f:
            key_shapes = json.load(f)
    rep = check_coverage(key_shapes, engine)
    ok = not rep["unmapped"] and not rep["missing"] and not rep["shape_mismatch"]
    print(json.dumps({
        "total_keys": rep["total_keys"],
        "checked": rep["checked"],
        "unmapped": len(rep["unmapped"]),
        "missing": len(rep["missing"]),
        "shape_mismatch": len(rep["shape_mismatch"]),
        "ok": ok,
    }))
    for name in ("unmapped", "missing", "shape_mismatch"):
        for item in rep[name][:20]:
            print(f"  {name}: {item}")
    return 0 if ok else 1
