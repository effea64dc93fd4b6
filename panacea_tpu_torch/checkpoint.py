"""Checkpoints of the port: the reference's ``.ckpt`` format, and the
trainer's full-state checkpoints.

The port's parameter names are the reference checkpoint's own, so there is no
key map: a ``.ckpt`` is read with ``torch.load``, unwrapped
(``panacea_tpu/utils/convert.py:403-415``), a ``.safetensors`` file by the
port's own reader of the format (``read_safetensors``; no ``safetensors``
package is needed), its EMA shadows are swapped in
where asked (``:418-446``), and ``engine.load_state_dict(strict=True)`` takes
the rest. ``save_engine_checkpoint`` writes such a file from a trained
engine, with LitEma ``model_ema.*`` shadows when the EMA is on, so that
``inference_torch.py --ckpt`` loads what the trainer wrote. ``dry_convert``
is the name-and-shape check of a key list or a checkpoint against the engine
built on the meta device (the JAX CLI's ``--dry_convert`` drill).

The trainer's checkpoints (counterparts of
``panacea_tpu/utils/checkpoint.py:60-150``) are ``{ckpt_dir}/iter_{step}/``
directories holding one ``state.pt``: the trained parameters' fp32 masters,
the frozen network parameters, the optimizer, the step, the EMA and the
host-side streams (torch generator, numpy ``RandomState``, the dataset's
``random.Random``), so that a resumed run replays the uninterrupted one. The
newest ``max_keep`` are kept.

With a sharded training state (``state.shards``, ``parallel/fsdp.py``) the
files are the same, with the same keys and whole tensors: every rank takes
part in gathering them a bucket at a time (``Shards.full``) and rank 0
writes. A rank that loads one keeps its slices of what it reads (the file
is memory-mapped), so a checkpoint crosses between the sharded and the
replicated layouts, and between world sizes.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from panacea_tpu_torch.models.engine import is_non_weight

_EMA_COUNTERS = ("model_ema.decay", "model_ema.num_updates")
PICKLED_SUFFIXES = (".ckpt", ".pth")
CHECKPOINT_SUFFIXES = PICKLED_SUFFIXES + (".safetensors",)
# the safetensors element types: name -> (numpy type of the bytes, torch type)
_SAFETENSORS_TYPES = {
    "F64": (np.float64, torch.float64), "F32": (np.float32, torch.float32),
    "F16": (np.float16, torch.float16), "BF16": (np.int16, torch.bfloat16),
    "I64": (np.int64, torch.int64), "I32": (np.int32, torch.int32),
    "I16": (np.int16, torch.int16), "I8": (np.int8, torch.int8),
    "U8": (np.uint8, torch.uint8), "BOOL": (np.bool_, torch.bool)}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` file as a dict of CPU tensors, parsed here: a
    little-endian u64 header length, a JSON header (each tensor's
    ``dtype``, ``shape`` and ``data_offsets`` into the data that follows;
    ``__metadata__`` is skipped), then the raw little-endian bytes. Types
    F64, F32, F16, BF16, I64, I32, I16, I8, U8 and BOOL. A header or an
    entry that does not fit the file raises ValueError naming the file."""
    data = np.memmap(path, dtype=np.uint8, mode="r")

    def bad(why: str) -> ValueError:
        return ValueError(f"{path}: not a readable .safetensors file ({why})")

    if data.size < 8:
        raise bad("shorter than its 8-byte header length")
    n = int(np.frombuffer(data[:8].tobytes(), dtype="<u8")[0])
    if n > data.size - 8:
        raise bad(f"a header of {n} bytes in a file of {data.size}")
    try:
        header = json.loads(data[8:8 + n].tobytes().decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise bad(f"its header is not JSON: {e}") from None
    if not isinstance(header, dict):
        raise bad("its header is not an object")
    body = data[8 + n:]
    out = {}
    for name, entry in header.items():
        if name == "__metadata__":
            continue
        try:
            np_type, torch_type = _SAFETENSORS_TYPES[entry["dtype"]]
            shape = [int(d) for d in entry["shape"]]
            begin, end = (int(o) for o in entry["data_offsets"])
        except (KeyError, TypeError, ValueError) as e:
            raise bad(f"entry {name!r}: {e!r}") from None
        count = int(np.prod(shape, dtype=np.int64))
        if not 0 <= begin <= end <= body.size or end - begin != count * np.dtype(
                np_type).itemsize:
            raise bad(f"entry {name!r}: bytes [{begin}, {end}) for {entry['dtype']} "
                      f"{shape} in {body.size} bytes of data")
        values = np.frombuffer(body[begin:end].tobytes(), dtype=np.dtype(np_type).newbyteorder(
            "<")).astype(np_type).reshape(shape)
        t = torch.from_numpy(values)
        out[name] = t.view(torch_type) if torch_type == torch.bfloat16 else t
    return out


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A Lightning/DeepSpeed ``.ckpt`` as a flat state dict on the CPU: the
    ``state_dict`` entry where there is one, DeepSpeed's ``_forward_module.``
    wrapper prefix removed (reference inference.py:207-218). The file is
    unpickled in full, as such checkpoints hold more than tensors: load only
    files you trust. A ``.safetensors`` file is read as it is
    (``read_safetensors``), as the JAX package reads it."""
    if path.endswith(".safetensors"):
        return read_safetensors(path)
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


# ------------------------------------------------------------------ training

_ITER_RE = re.compile(r"^iter_(\d+)$")
_STATE_FILE = "state.pt"


def _iter_checkpoints(ckpt_dir: str) -> List[Tuple[int, str]]:
    """[(step, path)] of the iter_N checkpoint directories, oldest first."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = _ITER_RE.match(name)
        full = os.path.join(ckpt_dir, name)
        if m and os.path.isfile(os.path.join(full, _STATE_FILE)):
            out.append((int(m.group(1)), full))
    return sorted(out)


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The newest iter_N checkpoint under ``ckpt_dir``, or None."""
    ckpts = _iter_checkpoints(ckpt_dir)
    return ckpts[-1][1] if ckpts else None


def is_train_checkpoint(path: str) -> bool:
    """True for an iter_N directory or a directory holding some."""
    if not path or not os.path.isdir(path):
        return False
    if _ITER_RE.match(os.path.basename(os.path.normpath(path))):
        return True
    return latest_checkpoint(path) is not None


def _frozen(engine, state) -> Dict[str, torch.Tensor]:
    return {f"model.{n}": p for n, p in engine.model.named_parameters()
            if f"model.{n}" not in state.params}


def _whole(shards, tensors: Mapping[str, torch.Tensor]) -> Optional[Dict[str, torch.Tensor]]:
    """``tensors`` whole: as they are without shards; gathered on rank 0
    (None on the others) with them."""
    return dict(tensors) if shards is None else shards.full(dict(tensors))


def _local(shards, name: str, full: torch.Tensor) -> torch.Tensor:
    return full if shards is None else shards.local(name, full)


def network_state(state, engine) -> Optional[Dict[str, torch.Tensor]]:
    """The network's parameters whole in fp32 on the CPU (the trained ones
    from their masters), by ``model.*`` name; None on the ranks other than
    0 of a sharded state, which take part in the gathers."""
    named = {f"model.{n}": state.params.get(f"model.{n}", p)
             for n, p in engine.model.named_parameters()}
    out = _whole(state.shards, named)
    return None if out is None else {k: v.detach().float().cpu() for k, v in out.items()}


def ema_state(state) -> Optional[Dict[str, torch.Tensor]]:
    """The EMA shadows whole on the CPU (None where there is no EMA, and on
    the ranks other than 0 of a sharded state)."""
    if state.ema is None:
        return None
    out = _whole(state.shards, state.ema.shadows)
    return None if out is None else {k: v.cpu() for k, v in out.items()}


def save_train_checkpoint(ckpt_dir: str, state, engine, meta: Optional[Dict[str, Any]] = None,
                          max_keep: int = 3) -> str:
    """Write ``state`` (a ``train_step.TrainState``) and ``meta`` as
    ``{ckpt_dir}/iter_{state.step}`` and remove all but the newest
    ``max_keep`` iter_N checkpoints. With a sharded state every rank calls
    it (the whole tensors are gathered) and rank 0 writes."""
    path = os.path.join(os.path.abspath(ckpt_dir), f"iter_{int(state.step)}")
    shards = state.shards
    opt = state.optimizer.state_dict()
    blob = {"params": _whole(shards, state.params),
            "frozen": _whole(shards, _frozen(engine, state)),
            "optimizer": dict(opt, mu=_whole(shards, opt["mu"]), nu=_whole(shards, opt["nu"])),
            "step": int(state.step), "ema": None, "meta": dict(meta or {})}
    if state.ema is not None:
        ema = state.ema.state_dict()
        blob["ema"] = dict(ema, shadows=_whole(shards, ema["shadows"]))
    if shards is not None and shards.rank != 0:
        return path
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, _STATE_FILE + ".tmp")
    torch.save(blob, tmp)
    os.replace(tmp, os.path.join(path, _STATE_FILE))
    if max_keep and max_keep > 0:
        for _, old in _iter_checkpoints(ckpt_dir)[:-max_keep]:
            shutil.rmtree(old, ignore_errors=True)
    return path


def load_train_checkpoint(path: str, state, engine) -> Dict[str, Any]:
    """Restore ``state`` and the engine's network from ``path`` (an iter_N
    directory, or a directory whose newest iter_N is taken); with a sharded
    state, this rank's slices of it. Returns the meta dict saved with it."""
    path = os.path.abspath(path)
    if not _ITER_RE.match(os.path.basename(path)):
        newest = latest_checkpoint(path)
        if newest is None:
            raise FileNotFoundError(f"no iter_* checkpoint under {path}")
        path = newest
    blob = torch.load(os.path.join(path, _STATE_FILE), map_location="cpu", weights_only=False,
                      mmap=True)
    shards = state.shards
    if sorted(blob["params"]) != sorted(state.params):
        raise KeyError(f"{path}: the trained parameters differ from this run's "
                       "(another freeze_type or config?)")
    frozen = _frozen(engine, state)
    if sorted(blob["frozen"]) != sorted(frozen):
        raise KeyError(f"{path}: the frozen parameters differ from this run's")
    if (blob["ema"] is None) != (state.ema is None):
        raise ValueError(f"{path}: EMA {'absent' if blob['ema'] is None else 'present'} "
                         "in the checkpoint, not in this run")
    with torch.no_grad():
        for k, p in state.params.items():
            p.copy_(_local(shards, k, blob["params"][k]))
        for k, p in frozen.items():
            p.copy_(_local(shards, k, blob["frozen"][k]))
    opt = blob["optimizer"]
    state.optimizer.load_state_dict(dict(
        opt, mu={k: _local(shards, k, v) for k, v in opt["mu"].items()},
        nu={k: _local(shards, k, v) for k, v in opt["nu"].items()}))
    if state.ema is not None:
        ema = blob["ema"]
        state.ema.load_state_dict(dict(ema, shadows={k: _local(shards, k, v)
                                                     for k, v in ema["shadows"].items()}))
    state.step = int(blob["step"])
    state.sync_network()
    return dict(blob["meta"], step=state.step, path=path)


def save_engine_checkpoint(path: str, engine, state=None, ema=None) -> str:
    """Write the engine as a reference-style ``.ckpt`` (``{"state_dict":
    ...}``) that ``load_checkpoint`` and ``inference_torch.py --ckpt`` take
    with ``strict=True``: its weights under the reference's names, the
    trained ones from their fp32 masters in ``state``, and with ``ema``
    LitEma's ``model_ema.*`` shadows (one per trained parameter, named as
    ema.py:5-26 names them, and its decay and update-count buffers), which
    ``--prefer_ema`` swaps in. With a sharded state (``engine.shards``)
    every rank calls it, the whole tensors are gathered a bucket at a time,
    and rank 0 writes."""
    if not path.endswith(PICKLED_SUFFIXES):
        path += ".ckpt"
    shards = engine.shards
    sd = dict(engine.state_dict())
    trained = {} if state is None else state.params
    if shards is not None:
        whole = shards.full({k: v for k, v in sd.items()
                             if k in shards.leaves and k not in trained})
        if whole is not None:
            sd.update(whole)
    if state is not None:
        sd.update(_whole(shards, trained) or {})
    if ema is not None:
        for k, v in (_whole(shards, ema.shadows) or {}).items():
            sd["model_ema." + k[len("model."):].replace(".", "")] = v
        sd["model_ema.decay"] = torch.tensor(ema.decay, dtype=torch.float32)
        sd["model_ema.num_updates"] = torch.tensor(max(ema.num_updates, 0), dtype=torch.int32)
    if shards is not None and shards.rank != 0:
        return path
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({"state_dict": {k: v.detach().cpu() for k, v in sd.items()}}, path)
    return path
