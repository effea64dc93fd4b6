"""The port's inference CLI and what it is made of, against the JAX package.

Config overrides, the phase timer, the rollout loop (a recording stub engine
on both sides), the checkpoint loader on a ``.ckpt`` written from the JAX
engine's export, the ``--dry_convert`` drill, the latent-trajectory dump and
the CLI itself on the tiny config. JAX keys and ``torch.Generator`` give
different noise, so the CLIs are compared on layout and determinism, and
numbers are compared through injected numpy noise.
"""

import argparse
import copy
import importlib.util
import json
import os

import jax
import numpy as np
import pytest
import torch

from panacea_tpu import config as jconfig
from panacea_tpu import rollout as jrollout
from panacea_tpu.data.nuscenes import dataset as jdataset
from panacea_tpu.data.nuscenes import synthetic as jsynthetic
from panacea_tpu.registry import instantiate_from_config as jax_instantiate
from panacea_tpu.utils.convert import export_panacea_checkpoint
from panacea_tpu_torch import checkpoint, config, configs, inference, rollout
from panacea_tpu_torch.convert import state_dict_from_jax
from panacea_tpu_torch.data.nuscenes import dataset, synthetic
from panacea_tpu_torch.registry import instantiate_from_config
from panacea_tpu_torch.utils.profiling import Timer

ROOT = os.path.join(os.path.dirname(__file__), "..")
JAX_CONFIGS = os.path.join(ROOT, "panacea_tpu", "configs")
T, IH, IW, LH, LW = 2, 16, 192, 2, 24     # the tiny CLI geometry


def load_script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------------------ config

DOTLISTS = [
    ["model.params.scale_factor=0.5", "SampleStep=7"],
    ["model.params.network_config.params.channel_mult.1=3",
     "model.params.network_config.params.attention_resolutions=[4, 1]"],
    ["model.params.conditioner_config.params.emb_models.0.ucg_rate=0.3", "new.key.path=text",
     "flag=True", "none=None"],
]


@pytest.mark.parametrize("dotlist", DOTLISTS)
def test_apply_dotlist_equal(dotlist):
    want = jconfig.apply_dotlist(jconfig.load_config(os.path.join(JAX_CONFIGS, "tiny_cpu.yaml")),
                                 dotlist)
    got = config.apply_dotlist(config.load_config("tiny_cpu"), dotlist)
    assert got == want
    assert configs.TINY_CPU == jconfig.load_config(os.path.join(JAX_CONFIGS, "tiny_cpu.yaml"))
    with pytest.raises(ValueError, match="not key=value"):
        config.apply_dotlist({}, ["novalue"])


@pytest.mark.parametrize("name,const", [("inference_nuscenes", "INFERENCE_NUSCENES"),
                                        ("tiny_cpu", "TINY_CPU"),
                                        ("tiny_stage1", "TINY_STAGE1")])
def test_named_configs_equal_the_yaml_and_are_copies(name, const):
    path = os.path.join(JAX_CONFIGS, f"{name}.yaml")
    want = jconfig.load_config(path)
    assert config.load_config(name) == want == getattr(configs, const)
    assert config.load_config(path) == want            # a YAML path, where PyYAML imports
    cfg = config.load_config(name)
    cfg["model"]["params"]["scale_factor"] = -1.0       # a copy: the module's data stays
    assert getattr(configs, const)["model"]["params"]["scale_factor"] == 0.18215
    with pytest.raises(FileNotFoundError, match="not one of"):
        config.load_config(f"no/such/dir/{name}.yaml")


def test_merge_and_load_with_overrides_equal():
    a = {"x": {"y": 1, "z": [1, 2]}, "k": 1}
    b = {"x": {"y": 2, "w": 3}, "k": {"deep": 1}}
    assert config.merge_configs(a, b) == jconfig.merge_configs(a, b)
    assert config.merge_configs(a, b, None) == {"x": {"y": 2, "z": [1, 2], "w": 3},
                                                "k": {"deep": 1}}
    paths = [os.path.join(JAX_CONFIGS, "tiny_cpu.yaml")]
    dots = ["model.params.sampler_config.params.num_steps=3"]
    assert (config.load_configs_with_overrides(["tiny_cpu"], dots)
            == jconfig.load_configs_with_overrides(paths, dots))


def test_timer_accumulates_like_the_jax_package():
    from panacea_tpu.utils.profiling import Timer as JTimer

    for cls, args in ((Timer, ()), (Timer, ("cpu",)), (JTimer, ())):
        timer = cls(*args)
        for _ in range(2):
            with timer("a"):
                pass
        with pytest.raises(KeyError):
            with timer("b"):
                raise KeyError("x")
        assert timer.counts == {"a": 2, "b": 1}
        assert timer.mean("a") == timer.totals["a"] / 2 and timer.last["b"] >= 0
        assert timer.report().startswith("a: 0.00s (avg 0.00s) b: ")


# ----------------------------------------------------------------- rollout

class RecordingEngine:
    """Stands in for the engine on both sides: records what ``log_images`` is
    given and returns samples that depend on the window's conditioning."""

    num_frames = T
    device = torch.device("cpu")

    def __init__(self):
        self.calls = []

    def log_images(self, batch, N, num_steps=None, share_noise_frame=-1, **random_source):
        assert N == 1 and len(random_source) == 1
        self.calls.append({"batch": copy.deepcopy(batch), "num_steps": num_steps,
                           "share_noise_frame": share_noise_frame,
                           "random_source": next(iter(random_source.values()))})
        fcz = np.asarray(batch["final_cond_zero"][0])
        samples = 0.5 * np.asarray(batch["jpg"][0]) + 0.25 * fcz.sum(axis=0, keepdims=True)
        return {"samples": samples + 0.01 * len(self.calls)}


def test_rollout_gives_the_engine_the_same_batches_and_stitches_the_same_frames():
    def run(mod_rollout, mod_dataset, mod_synthetic, **kw):
        infos = mod_synthetic.make_synthetic_infos(num_frames=8, seed=1)
        ds = mod_dataset.NuScenesVideoDataset(
            infos=infos, queue_length=T, final_dim=(IH, IW // 6),
            image_loader=mod_synthetic.synthetic_image_loader, seed=1)
        eng = RecordingEngine()
        return eng, mod_rollout.rollout(eng, ds, T - 1, 3, num_steps=4, **kw)

    gen = torch.Generator().manual_seed(5)
    eng, out = run(rollout, dataset, synthetic, generator=gen)
    jeng, jout = run(jrollout, jdataset, jsynthetic, rng=jax.random.PRNGKey(5))
    assert len(eng.calls) == len(jeng.calls) == 3
    for call, jcall in zip(eng.calls, jeng.calls):
        assert call["share_noise_frame"] == jcall["share_noise_frame"]
        assert call["num_steps"] == jcall["num_steps"] == 4
        assert call["batch"]["txt"] == jcall["batch"]["txt"]
        for k in ("jpg", "cond_img", "final_cond_zero"):
            np.testing.assert_array_equal(call["batch"][k], jcall["batch"][k], err_msg=k)
    # windows after the first are conditioned on the previous window's last
    # generated frame in slot 0, and anchor the shared noise there
    assert [c["share_noise_frame"] for c in eng.calls] == [-1, 0, 0]
    np.testing.assert_array_equal(eng.calls[1]["batch"]["final_cond_zero"][0, 0],
                                  out["windows"][0]["samples"][-1])
    assert not eng.calls[1]["batch"]["final_cond_zero"][0, 1:].any()
    # one generator, advanced by use, where the JAX rollout splits a key per window
    assert all(c["random_source"] is gen for c in eng.calls)
    assert len({tuple(np.asarray(c["random_source"]).ravel()) for c in jeng.calls}) == 3
    assert out["frames"].shape == (3 * T - 2, IH, IW, 3)
    np.testing.assert_array_equal(out["frames"], jout["frames"])
    assert out["filenames"] == jout["filenames"] and len(out["filenames"]) == 3 * T


def test_log_images_hands_share_noise_frame_to_sample():
    """``rollout`` relies on ``log_images`` passing ``share_noise_frame`` on:
    with it 0 the shared-noise bias comes from concat[0], not concat[-1]."""
    eng = instantiate_from_config(configs.TINY_CPU["model"], device="cpu")
    eng.init_weights(torch.Generator().manual_seed(0))
    seen = []
    real = eng.sample

    def spy(*a, **kw):
        seen.append(kw.get("share_noise_frame"))
        return real(*a, **kw)

    eng.sample = spy
    rs = np.random.RandomState(0)
    batch = {"jpg": rs.uniform(-1, 1, (1, T, IH, IW, 3)).astype(np.float32),
             "cond_img": rs.uniform(0, 1, (1, T, IH, IW, 19)).astype(np.float32),
             "final_cond_zero": np.zeros((1, T, IH, IW, 3), np.float32), "txt": ["x"]}
    batch["final_cond_zero"][0, 0] = batch["jpg"][0, 0]
    outs = [eng.log_images(batch, N=1, generator=torch.Generator().manual_seed(1), num_steps=1,
                           share_noise_frame=f)["samples"] for f in (0, -1)]
    assert seen == [0, -1]
    assert not torch.equal(outs[0], outs[1])


# -------------------------------------------------------------- checkpoint

@pytest.fixture(scope="module")
def jax_tiny():
    """A tiny JAX engine with random offsets on every parameter (zero-inits
    included), and its export under the reference checkpoint's names.

    The VAE's last encoder layer (``quant_conv``) gets a zero kernel and a
    log-variance bias of -30, so that its posterior is N(bias, (3e-7)^2)
    whatever the image. Two reasons, both from the trajectory dump, which
    encodes an all-zero conditioning image: JAX keys and ``torch.Generator``
    draw different posterior noise, and on a constant image the tiny VAE's
    GroupNorms (16 channels in 16 groups) divide by a variance that is
    rounding noise, which the two packages round differently (up to 5 % of
    the latent; not so on a random image, where tests/test_torch_engine.py
    holds the encoders to 1e-5, nor at the production VAE's 4 channels a
    group)."""
    jeng = jax_instantiate(jconfig.load_config(os.path.join(JAX_CONFIGS, "tiny_cpu.yaml"))["model"])
    jeng.init_params(jax.random.PRNGKey(0), latent_hw=(LH, LW), image_hw=(IH, IW))
    rng = np.random.default_rng(0)

    def offset(p):
        return np.asarray(p) + 0.02 * rng.standard_normal(p.shape).astype(np.float32)

    clip = jeng.conditioner.embedders[0]
    jeng.params = jax.tree.map(offset, jeng.params)
    clip.params = jax.tree.map(offset, clip.params)
    quant = jeng.params["first_stage"]["quant_conv"]
    quant["kernel"][...] = 0.0
    quant["bias"][4:] = -30.0
    sd, _ = export_panacea_checkpoint(jeng)
    return jeng, {k: np.asarray(v) for k, v in sd.items()}


def deepspeed_ckpt(sd, path, wrap=True, ema=True):
    """``sd`` as a DeepSpeed Lightning checkpoint: ``_forward_module.`` before
    every name, LitEma shadows of the ``model.*`` weights (here the weight
    plus 1) and its two counters, non-weight buffers."""
    out = {f"_forward_module.{k}": torch.from_numpy(v.copy()) for k, v in sd.items()}
    if ema:
        for k, v in sd.items():
            if k.startswith("model."):
                shadow = "model_ema." + k[len("model."):].replace(".", "")
                out[f"_forward_module.{shadow}"] = torch.from_numpy(v + 1.0)
        out["_forward_module.model_ema.decay"] = torch.tensor(0.9999)
        out["_forward_module.model_ema.num_updates"] = torch.tensor(7)
    out["_forward_module.conditioner.embedders.0.model.logit_scale"] = torch.tensor(4.6)
    torch.save({"state_dict": out, "epoch": 3} if wrap else out, path)
    return path


def jax_params(jeng):
    return {"model": jeng.params["model"], "first_stage": jeng.params["first_stage"],
            "clip": jeng.conditioner.embedders[0].params}


@pytest.mark.parametrize("wrap", [True, False])
def test_checkpoint_loads_equal_to_state_dict_from_jax(jax_tiny, tmp_path, wrap):
    jeng, sd = jax_tiny
    path = deepspeed_ckpt(sd, str(tmp_path / "tiny.ckpt"), wrap=wrap)
    eng = instantiate_from_config(configs.TINY_CPU["model"], device="cpu")
    report = checkpoint.load_checkpoint(path, eng)      # strict=True inside
    want = state_dict_from_jax(jax_params(jeng), configs.TINY_CPU["model"])
    got = eng.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v.numpy(), err_msg=k)
    assert report["weights"] == "raw" and report["ema_available"] and report["ema_swapped"] == 0
    assert report["loaded"] == len(want)


def test_prefer_ema_swaps_the_shadows_in(jax_tiny, tmp_path):
    _, sd = jax_tiny
    path = deepspeed_ckpt(sd, str(tmp_path / "tiny.ckpt"))
    eng = instantiate_from_config(configs.TINY_CPU["model"], device="cpu")
    report = checkpoint.load_checkpoint(path, eng, prefer_ema=True)
    n_model = sum(k.startswith("model.") for k in sd)
    assert report["weights"] == "ema" and report["ema_swapped"] == n_model > 0
    for k, v in eng.state_dict().items():
        want = sd[k] + 1.0 if k.startswith("model.") else sd[k]
        np.testing.assert_array_equal(v.numpy(), want, err_msg=k)
    # the JAX package derives the same shadow names
    from panacea_tpu.utils.convert import apply_ema_weights as japply

    flat = checkpoint.load_torch_checkpoint(path)
    swapped, n = checkpoint.apply_ema_weights(flat)
    jswapped, jn = japply({k: v.numpy() for k, v in flat.items()})
    assert n == jn == n_model and sorted(swapped) == sorted(jswapped)
    for k in swapped:
        np.testing.assert_array_equal(swapped[k].numpy(), jswapped[k], err_msg=k)


def test_checkpoint_loader_refuses_what_does_not_fit(jax_tiny, tmp_path):
    _, sd = jax_tiny
    eng = instantiate_from_config(configs.TINY_CPU["model"], device="cpu")
    no_ema = deepspeed_ckpt(sd, str(tmp_path / "raw.ckpt"), ema=False)
    with pytest.raises(ValueError, match="no model_ema"):
        checkpoint.load_checkpoint(no_ema, eng, prefer_ema=True)
    first = next(iter(sd))
    short = {k: v for k, v in sd.items() if k != first}
    with pytest.raises(RuntimeError, match="Missing key"):
        checkpoint.load_checkpoint(deepspeed_ckpt(short, str(tmp_path / "s.ckpt")), eng)
    extra = dict(sd, **{"model.diffusion_model.not_a_weight": np.zeros(1, np.float32)})
    with pytest.raises(RuntimeError, match="Unexpected key"):
        checkpoint.load_checkpoint(deepspeed_ckpt(extra, str(tmp_path / "e.ckpt")), eng)
    with pytest.raises(ValueError, match="safetensors"):
        checkpoint.load_torch_checkpoint("weights.safetensors")


def run_cli(argv):
    with pytest.raises(SystemExit) as exc:
        inference.main(argv)
    return exc.value.code


def test_dry_convert_prints_the_coverage_line(jax_tiny, tmp_path, capsys):
    """The JSON line of the JAX CLI's drill: the production key list against
    the engine on the meta device, and a tiny checkpoint against the tiny
    engine; a checkpoint that does not fit exits 1 and names what is wrong."""
    assert run_cli(["--dry_convert"]) == 0
    line = json.loads(capsys.readouterr().out.splitlines()[0])
    with open(os.path.join(ROOT, "tests", "fixtures", "panaceaplus_keys.json")) as f:
        n_keys = len(json.load(f))
    assert line == {"total_keys": n_keys, "checked": line["checked"], "unmapped": 0,
                    "missing": 0, "shape_mismatch": 0, "ok": True}
    assert 0 < line["checked"] <= n_keys

    _, sd = jax_tiny
    path = deepspeed_ckpt(sd, str(tmp_path / "tiny.ckpt"))
    assert run_cli(["--tiny", "--dry_convert", path]) == 0
    assert json.loads(capsys.readouterr().out.splitlines()[0])["ok"] is True
    assert run_cli(["--dry_convert", path]) == 1          # tiny weights, production engine
    out = capsys.readouterr().out.splitlines()
    bad = json.loads(out[0])
    assert bad["ok"] is False and bad["missing"] > 0 and bad["shape_mismatch"] > 0
    assert any(line.startswith("  missing: ") for line in out[1:])


# -------------------------------------------------------- trajectory dump

def test_dump_matches_the_jax_sampler_and_the_jax_compare_reads_it(jax_tiny, tmp_path, capsys):
    """``scripts/compare_latents_torch.py dump`` on the tiny engine with the
    JAX engine's weights, against the JAX engine on the same RandomState
    draws (the steps of ``scripts/compare_latents.py dump``): per-step
    latents within 1e-3, the fp32-vs-fp32 budget of that script; its
    ``compare`` mode reads both files."""
    jeng, sd = jax_tiny
    ckpt = deepspeed_ckpt(sd, str(tmp_path / "tiny.ckpt"), ema=False)
    ours, theirs = str(tmp_path / "torch.npz"), str(tmp_path / "jax.npz")
    load_script("compare_latents_torch").main(
        ["dump", "--tiny", "--device", "cpu", "--ckpt", ckpt, "--out", ours, "--num_steps", "2"])

    prompt = "a driving scene. daytime. sunny."
    rs = np.random.RandomState(0)
    batch = {"jpg": rs.uniform(-1, 1, (1, T, IH, IW, 3)).astype(np.float32),
             "cond_img": rs.uniform(0, 1, (1, T, IH, IW, 19)).astype(np.float32),
             "final_cond_zero": np.zeros((1, T, IH, IW, 3), np.float32), "txt": [prompt]}
    c, uc = jeng.conditioner.get_unconditional_conditioning(batch, batch_uc=dict(batch, txt=[""]))
    noise = rs.standard_normal((T, LH, LW, 4)).astype(np.float32)
    final, traj = jeng.sample(c, uc=uc, batch_size=T, shape=(LH, LW, 4),
                              rng=jax.random.PRNGKey(0), num_steps=2,
                              noise=jax.numpy.asarray(noise), return_trajectory=True)
    cond = {f"cond_{k}": np.asarray(v, np.float32) for k, v in c.items()}
    cond.update({f"uc_{k}": np.asarray(v, np.float32) for k, v in uc.items()})
    np.savez_compressed(theirs, traj=np.asarray(traj, np.float32),
                        final=np.asarray(final, np.float32), noise=noise, jpg=batch["jpg"],
                        cond_img=batch["cond_img"], txt=np.array([prompt]),
                        num_steps=np.array(2), seed=np.array(0), **cond)

    a, b = np.load(ours), np.load(theirs)
    assert sorted(a.files) == sorted(b.files)
    for k in ("noise", "jpg", "cond_img", "txt", "num_steps", "seed"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for k in cond:   # the conditioning first: a mismatch here is not the sampler's
        np.testing.assert_allclose(a[k], b[k], atol=1e-4, rtol=0, err_msg=k)
    assert a["traj"].shape == (2, T, LH, LW, 4)
    np.testing.assert_allclose(a["traj"], b["traj"], atol=1e-3, rtol=0)
    np.testing.assert_allclose(a["final"], b["final"], atol=1e-3, rtol=0)

    load_script("compare_latents").compare(argparse.Namespace(ours=ours, theirs=theirs, atol=1e-3))
    assert capsys.readouterr().out.rstrip().endswith("OK")


# ------------------------------------------------------------------ the CLI

def files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, names in os.walk(root) for f in names)


def test_cli_tiny_twice_gives_the_same_files_and_bytes(tmp_path):
    args = ["--tiny", "--synthetic", "--device", "cpu", "--num_batches", "1"]
    outs = [inference.main(args + ["--outdir", str(tmp_path / name)]) for name in ("a", "b")]
    assert [o["done"] for o in outs] == [1, 1]
    assert outs[0]["outdir"] == os.path.join(str(tmp_path / "a"), "panacea_tpu", "val")
    assert set(outs[0]["timer"].totals) == {"dataset", "clip", "to_host", "write"}
    tree = files(outs[0]["outdir"])
    assert tree == files(outs[1]["outdir"])
    stem = "synth__CAM_FRONT__000000000001"
    want = [f"{key}/{stem}.{ext}" for key in ("control", "inputs", "samples")
            for ext in ("gif", "png")]
    want += [f"gen-nuscenes/{cam}_synth__{cam}__000000000001/_{i:06d}.jpg"
             for cam in dataset.PANORAMA_VIEWS for i in range(T)]
    assert tree == sorted(want)
    for rel in tree:
        with open(os.path.join(outs[0]["outdir"], rel), "rb") as fa, \
                open(os.path.join(outs[1]["outdir"], rel), "rb") as fb:
            assert fa.read() == fb.read(), rel


def test_cli_rollout_and_overrides(tmp_path):
    out = inference.main(["--tiny", "--synthetic", "--device", "cpu", "--num_batches", "1",
                          "--rollout", "2", "--num_steps", "1", "--name", "run", "--split",
                          "train", "--outdir", str(tmp_path),
                          "model.params.share_noise_level=0.0"])
    assert out["done"] == 1 and out["outdir"] == os.path.join(str(tmp_path), "run", "train")
    stem = "synth__CAM_FRONT__000000000002"     # the second window's last frame
    assert files(out["outdir"]) == [f"rollout/{stem}/frame_{i:04d}.jpg"
                                    for i in range(2 * T - 1)] + [f"rollout/{stem}/long.gif"]
    from PIL import Image

    with Image.open(os.path.join(out["outdir"], "rollout", stem, "frame_0000.jpg")) as im:
        assert im.size == (IW, IH)


@pytest.mark.parametrize("case", ["no_card", "view_shard", "no_bpe", "ckpt_format"])
def test_cli_refuses(case, monkeypatch, tmp_path):
    base = ["--tiny", "--synthetic", "--num_batches", "1", "--outdir", str(tmp_path)]
    if case == "no_card":
        # --tiny picks the config and does not move the run to the CPU
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            inference.main(base)
    elif case == "view_shard":
        assert "not ported" in str(run_cli(base + ["--device", "cpu", "--view_shard", "2"]))
    elif case == "no_bpe":
        monkeypatch.delenv("PANACEA_CLIP_BPE", raising=False)
        assert "BPE merge table" in str(run_cli(["--tiny", "--device", "cpu"]))
    else:
        assert "not ported" in str(run_cli(base + ["--device", "cpu", "--ckpt", "ckpts/engine"]))
    assert not os.listdir(tmp_path)


def test_cli_parser_has_the_jax_clis_flags_and_defaults():
    spec = importlib.util.spec_from_file_location("jax_inference", os.path.join(ROOT, "inference.py"))
    jcli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jcli)
    want = vars(jcli.get_parser().parse_args([]))
    got = vars(inference.get_parser().parse_args([]))
    assert got.pop("device") is None                     # the one flag beyond the JAX CLI's
    assert got.pop("base") == ["inference_nuscenes"] and want.pop("base")   # a name, not a YAML path
    assert got == want
