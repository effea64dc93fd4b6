"""Config loading with CLI dotlist overrides (counterpart of
``panacea_tpu/config.py``).

The port's configs are Python data (``configs.py``), so ``--base`` names one
of them, ``inference_nuscenes``, ``tiny_cpu`` or ``tiny_stage1``. Anything else is read as a
YAML path, where PyYAML is installed. ``apply_dotlist`` keeps the
reference's ``--base cfg key.sub=value`` surface.
"""

from __future__ import annotations

import ast
import copy
import os
from typing import Any, Dict, List, Sequence

from panacea_tpu_torch import configs

NAMED = {"inference_nuscenes": configs.INFERENCE_NUSCENES, "tiny_cpu": configs.TINY_CPU,
         "tiny_stage1": configs.TINY_STAGE1}


def load_config(name_or_path: str) -> Dict[str, Any]:
    """A deep copy of the named config of ``configs.py``, or the YAML file at
    the path."""
    if name_or_path in NAMED:
        return copy.deepcopy(NAMED[name_or_path])
    if not os.path.isfile(name_or_path):
        raise FileNotFoundError(f"no config {name_or_path!r}: not one of {sorted(NAMED)} "
                                "and not a file")
    try:
        import yaml
    except ImportError as e:
        raise RuntimeError(f"reading {name_or_path} needs PyYAML, which is not installed; "
                           f"--base also takes one of {sorted(NAMED)}") from e
    with open(name_or_path, "r") as f:
        return yaml.safe_load(f)


def merge_configs(base: Dict[str, Any], *others: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(base)
    for other in others:
        for k, v in (other or {}).items():
            if isinstance(v, dict) and isinstance(out.get(k), dict):
                out[k] = merge_configs(out[k], v)
            else:
                out[k] = v
    return out


def _parse_value(s: str) -> Any:
    try:
        return ast.literal_eval(s)
    except (ValueError, SyntaxError):
        return s


def apply_dotlist(cfg: Dict[str, Any], dotlist: Sequence[str]) -> Dict[str, Any]:
    """Apply ``key.sub.path=value`` overrides in place (OmegaConf dotlist
    semantics, inference.py:247)."""
    for item in dotlist:
        if "=" not in item:
            raise ValueError(f"override {item!r} is not key=value")
        key, val = item.split("=", 1)
        parts = key.split(".")
        node = cfg
        for p in parts[:-1]:
            if isinstance(node, list):
                node = node[int(p)]
            else:
                node = node.setdefault(p, {})
        last = parts[-1]
        if isinstance(node, list):
            node[int(last)] = _parse_value(val)
        else:
            node[last] = _parse_value(val)
    return cfg


def load_configs_with_overrides(paths: List[str], dotlist: Sequence[str] = ()):
    cfgs = [load_config(p) for p in paths]
    cfg = merge_configs(*cfgs) if len(cfgs) > 1 else (cfgs[0] if cfgs else {})
    return apply_dotlist(cfg, dotlist)
