"""Guards of the port: it imports nothing of JAX or of the JAX package, its
engine runs on CUDA unless told otherwise, and its production model has
exactly the reference checkpoint's parameter names and shapes."""

import ast
import json
import os
import subprocess
import sys

import pytest
import torch

from panacea_tpu_torch.configs import INFERENCE_NUSCENES, TINY_CPU
from panacea_tpu_torch.models.engine import is_non_weight
from panacea_tpu_torch.registry import instantiate_from_config

ROOT = os.path.join(os.path.dirname(__file__), "..")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "panacea_tpu")
# the port's scripts outside its package
ROOT_SCRIPTS = ("chip_smoke.py", "inference_torch.py", "train_torch.py",
                "eval_perception_torch.py", "eval_generation_torch.py",
                "train_perception_torch.py",
                os.path.join("scripts", "compare_latents_torch.py"),
                os.path.join("scripts", "probe_torch_kernels.py"),
                os.path.join("scripts", "sampling_step_torch.py"),
                os.path.join("scripts", "flash_bwd_ablation.py"))


def port_files():
    pkg = os.path.join(ROOT, "panacea_tpu_torch")
    for d, _, files in os.walk(pkg):
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))
    for script in ROOT_SCRIPTS:
        yield os.path.join(ROOT, script)


def test_port_source_imports_no_jax():
    bad = []
    names = {os.path.relpath(p, ROOT) for p in port_files()}
    # the walk reaches the modules of this slice, the new root script included
    assert {"inference_torch.py", os.path.join("panacea_tpu_torch", "inference.py"),
            os.path.join("panacea_tpu_torch", "native", "__init__.py"),
            os.path.join("panacea_tpu_torch", "data", "nuscenes", "dataset.py"),
            os.path.join("panacea_tpu_torch", "writers.py"),
            os.path.join("panacea_tpu_torch", "rollout.py"),
            os.path.join("panacea_tpu_torch", "checkpoint.py"),
            os.path.join("panacea_tpu_torch", "utils", "profiling.py"),
            "train_torch.py", os.path.join("panacea_tpu_torch", "train.py"),
            os.path.join("panacea_tpu_torch", "train_step.py"),
            os.path.join("panacea_tpu_torch", "diffusion", "loss.py"),
            os.path.join("panacea_tpu_torch", "diffusion", "sigma_sampling.py"),
            os.path.join("panacea_tpu_torch", "utils", "ema.py"),
            os.path.join("panacea_tpu_torch", "utils", "optim.py"),
            os.path.join("panacea_tpu_torch", "utils", "lr_schedule.py"),
            "eval_perception_torch.py"} <= names
    assert {os.path.join("panacea_tpu_torch", "perception", f"{m}.py")
            for m in ("encoding", "resnet", "fpn", "deformable", "head", "detector", "coder",
                      "metrics", "eval_dataset", "collect", "eval", "train_losses", "atss",
                      "gridmask", "denoise", "train_dataset", "train", "train_cli", "vovnet",
                      "petr_head", "petr_head_dn", "motion_head")} <= names
    assert {os.path.join("panacea_tpu_torch", "losses", f"{m}.py")
            for m in ("__init__", "lpips", "vae_losses")} | {
        os.path.join("panacea_tpu_torch", "data", "loader.py")} <= names
    assert {"train_perception_torch.py",
            os.path.join("panacea_tpu_torch", "data", "nuscenes", "augment.py")} <= names
    assert {os.path.join("panacea_tpu_torch", "metrics_gen", f"{m}.py")
            for m in ("__init__", "fid", "inception", "i3d", "eval")} <= names
    assert {"eval_generation_torch.py",
            os.path.join("panacea_tpu_torch", "diffusion", "distributions.py")} <= names
    assert {os.path.join("panacea_tpu_torch", "models", f"{m}.py")
            for m in ("legacy_attention", "vae_temporal", "clip", "conditioner")} | {
        os.path.join("panacea_tpu_torch", "ops", "resize.py")} <= names
    for path in port_files():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            bad += [(path, n) for n in names if n.split(".")[0] in FORBIDDEN]
    assert not bad


def test_port_imports_with_jax_blocked():
    code = (
        "import sys, pkgutil, importlib\n"
        f"for m in {FORBIDDEN!r}: sys.modules[m] = None\n"
        "import panacea_tpu_torch\n"
        "for info in pkgutil.walk_packages(panacea_tpu_torch.__path__, 'panacea_tpu_torch.'):\n"
        "    importlib.import_module(info.name)\n"
        "import chip_smoke, inference_torch, train_torch, eval_perception_torch\n"
        "import eval_generation_torch, train_perception_torch\n"
        "sys.path.insert(0, 'scripts')\n"
        "import compare_latents_torch, probe_torch_kernels\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_engine_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        instantiate_from_config(INFERENCE_NUSCENES["model"])


def test_production_model_has_the_reference_keys():
    """Built on the meta device at production width: the names and shapes of
    tests/fixtures/panaceaplus_keys.json, less the known non-weights
    (convert.py:504-509), which load_state_dict drops."""
    with open(os.path.join(ROOT, "tests", "fixtures", "panaceaplus_keys.json")) as f:
        ref = json.load(f)
    want = {k: tuple(v) for k, v in ref.items() if not is_non_weight(k)}
    eng = instantiate_from_config(INFERENCE_NUSCENES["model"], device="meta")
    got = {k: tuple(v.shape) for k, v in eng.state_dict().items()}
    assert got == want
    # the reference state dict, non-weights included, loads with strict=True
    meta = {k: torch.empty(v, device="meta") for k, v in ref.items()}
    eng.load_state_dict(meta, strict=True, assign=True)


def test_init_weights_zero_inits_what_the_jax_modules_zero_init():
    eng = instantiate_from_config(TINY_CPU["model"], device="cpu")
    eng.init_weights(torch.Generator().manual_seed(0))
    sd = eng.state_dict()
    net = "model.diffusion_model."
    for key in (net + "out.2.weight", net + "input_blocks.1.1.proj_out.weight",
                net + "input_blocks.1.0.in_layers_temporal.2.weight",
                net + "controlnet.zero_convs.0.0.weight",
                net + "controlnet.input_hint_block.14.weight"):
        assert not sd[key].any(), key
    for key in (net + "input_blocks.1.0.in_layers.2.weight", net + "time_embed.0.weight",
                "first_stage_model.decoder.conv_in.weight"):
        assert sd[key].std() > 0, key
    eng.init_weights(torch.Generator().manual_seed(0), zero_init_std=0.02)
    assert eng.state_dict()[net + "out.2.weight"].std() > 0
