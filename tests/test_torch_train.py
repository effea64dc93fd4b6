"""The port's training path against the JAX package's.

A tiny JAX engine (``tiny_cpu.yaml``) and the port's engine from
``configs.TINY_CPU`` share every weight through ``state_dict_from_jax``
(random offsets on all parameters, zero-inits included). The JAX loss and
gradients (``jax.value_and_grad(DiffusionEngine3D.train_loss)``) are
computed once per module; the port gets the same random draws, replayed from
the JAX keys as numpy arrays (posterior noise, sigma indices, noise). The
latent is 8 x 96, so the level-0 cross-view call takes the port's flash
route and its autograd Function. Tolerances are stated at each comparison.
"""

import importlib.util
import os
import shutil
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from panacea_tpu.config import load_config
from panacea_tpu.diffusion import sigma_sampling as jax_sigma
from panacea_tpu.parallel.train import make_optimizer as jax_make_optimizer
from panacea_tpu.registry import instantiate_from_config as jax_instantiate
from panacea_tpu.utils import lr_schedule as jax_lr
from panacea_tpu.utils.ema import ema_init, ema_update
from panacea_tpu_torch import checkpoint, train
from panacea_tpu_torch.configs import TINY_CPU
from panacea_tpu_torch.convert import state_dict_from_jax
from panacea_tpu_torch.diffusion import sigma_sampling
from panacea_tpu_torch.diffusion.loss import StandardDiffusionLoss
from panacea_tpu_torch.registry import instantiate_from_config
from panacea_tpu_torch.utils import lr_schedule
from panacea_tpu_torch.utils.ema import LitEma
from panacea_tpu_torch.utils.optim import AdamW

ROOT = os.path.join(os.path.dirname(__file__), "..")
CFG = os.path.join(ROOT, "panacea_tpu", "configs", "tiny_cpu.yaml")
T, IH, IW = 2, 64, 768
LH, LW = 8, 96
DDPM = {"target": "sgm.modules.diffusionmodules.discretizer.LegacyDDPMDiscretization"}


def _to_port(jeng, model_tree):
    """A tree shaped like the JAX model params -> the port's ``model.*``
    tensors (kernels transposed as the weights are)."""
    clip = jeng.conditioner.embedders[0]
    sd = state_dict_from_jax({"model": model_tree, "first_stage": jeng.params["first_stage"],
                              "clip": clip.params}, TINY_CPU["model"])
    return {k: v for k, v in sd.items() if k.startswith("model.")}


@pytest.fixture(scope="module")
def setup():
    cfg = load_config(CFG)
    jeng = jax_instantiate(cfg["model"])
    jeng.loss_fn = jax_instantiate(cfg["loss_fn_config"])
    jeng.init_params(jax.random.PRNGKey(0), latent_hw=(LH, LW), image_hw=(IH, IW))
    rng = np.random.default_rng(0)

    def offset(p):
        return np.asarray(p) + 0.02 * rng.standard_normal(p.shape).astype(np.float32)

    clip = jeng.conditioner.embedders[0]
    jeng.params = jax.tree.map(offset, jeng.params)
    clip.params = jax.tree.map(offset, clip.params)
    eng = instantiate_from_config(TINY_CPU["model"], device="cpu")
    eng.load_state_dict(state_dict_from_jax(
        {"model": jeng.params["model"], "first_stage": jeng.params["first_stage"],
         "clip": clip.params}, TINY_CPU["model"]), strict=True)
    eng.loss_fn = instantiate_from_config(TINY_CPU["loss_fn_config"])

    data = np.random.default_rng(1)
    jpg = data.uniform(-1, 1, (1, T, IH, IW, 3)).astype(np.float32)
    cond = {"crossattn": data.standard_normal((1, 77, 64)).astype(np.float32),
            "concat": (data.standard_normal((T, LH, LW, 4)) * 0.5).astype(np.float32),
            "cond_feat": data.uniform(0, 1, (T, IH, IW, 19)).astype(np.float32)}
    key = jax.random.PRNGKey(7)
    loss_fn = jax.jit(jax.value_and_grad(jeng.train_loss))
    loss, grads = loss_fn(jeng.params["model"], jeng.params["first_stage"], jnp.asarray(jpg),
                          jax.tree.map(jnp.asarray, cond), key)
    # the draws of train_loss (engine.py:485-495, encode_impl, loss.py), replayed
    k_enc, k_loss = jax.random.split(key)
    posterior = np.concatenate([np.asarray(jax.random.normal(k, (1, LH, LW, 4)))
                                for k in jax.random.split(k_enc, T)])
    k_sigma, k_noise, _ = jax.random.split(k_loss, 3)
    draws = {"posterior_noise": posterior,
             "sigma_rand": np.asarray(jax.random.randint(k_sigma, (T,), 0, 1000)),
             "noise": np.asarray(jax.random.normal(k_noise, (T, LH, LW, 4)))}
    return types.SimpleNamespace(jeng=jeng, eng=eng, jpg=jpg, cond=cond, draws=draws,
                                 loss=float(loss), grads=_to_port(jeng, grads))


def _port_loss_and_grads(s):
    trained = s.eng.set_trainable()
    for p in trained.values():
        p.grad = None
    cond = {k: torch.from_numpy(v) for k, v in s.cond.items()}
    inject = {k: torch.from_numpy(v) for k, v in s.draws.items()}
    loss = s.eng.train_loss(s.jpg, cond, **inject)
    loss.backward()
    return loss.item(), {k: p.grad.clone() for k, p in trained.items()}


def test_train_loss_and_every_gradient_match_jax(setup, monkeypatch):
    A = __import__("panacea_tpu_torch.ops.attention", fromlist=["x"])
    routes = []
    real = A.flash_attention
    monkeypatch.setattr(A, "flash_attention",
                        lambda q, *a, **kw: routes.append(q.requires_grad) or real(q, *a, **kw))
    loss, grads = _port_loss_and_grads(setup)
    assert routes and all(routes)  # the cross-view calls went through the autograd Function
    # fp32 on both sides, summation orders differing through the whole
    # network and its backward, and the tiny config's temporal GroupNorms
    # (statistics over 2 values) amplify those differences in the backward
    # pass. The loss to 1e-6 relative. Each gradient tensor to 5e-4 of its
    # own largest entry (measured: median 1.2e-4, 90th percentile 1.7e-4)
    # plus 1e-6 of the largest gradient of all: the
    # floor serves the conv biases that a GroupNorm follows, whose exact
    # gradient is zero and whose computed one is rounding noise (1e-9).
    # All gradients together to 1e-4 (measured 6.2e-5).
    np.testing.assert_allclose(loss, setup.loss, rtol=1e-6)
    assert sorted(grads) == sorted(setup.grads)
    top = max(w.abs().max().item() for w in setup.grads.values())
    for k, want in setup.grads.items():
        err = (grads[k] - want).abs().max().item()
        assert err <= 5e-4 * want.abs().max().item() + 1e-6 * top, (k, err)
    num = sum((grads[k] - w).square().sum() for k, w in setup.grads.items())
    den = sum(w.square().sum() for w in setup.grads.values())
    assert (num / den).sqrt() < 1e-4


def test_use_checkpoint_gives_the_same_loss_and_gradients(setup):
    """The counterpart of tests/test_rollout.py:46: recomputing the ResBlocks
    and transformers in the backward pass changes no number (fp32, CPU)."""
    nets = [setup.eng.model.diffusion_model, setup.eng.model.diffusion_model.controlnet]
    assert all(n.use_checkpoint for n in nets)
    loss_on, grads_on = _port_loss_and_grads(setup)
    try:
        for n in nets:
            n.use_checkpoint = False
        loss_off, grads_off = _port_loss_and_grads(setup)
    finally:
        for n in nets:
            n.use_checkpoint = True
    assert loss_on == loss_off
    for k in grads_on:
        torch.testing.assert_close(grads_on[k], grads_off[k], rtol=0, atol=1e-7)


def test_checkpointing_recomputes_the_blocks(setup, monkeypatch):
    """With use_checkpoint and autograd recording, each ResBlock3D and each
    SpatialTemporalTransformer runs twice (forward and recompute)."""
    from panacea_tpu_torch.models.layers import ResBlock3D

    calls = []
    real = ResBlock3D.forward
    monkeypatch.setattr(ResBlock3D, "forward",
                        lambda self, *a: calls.append(1) or real(self, *a))
    _port_loss_and_grads(setup)
    n_blocks = sum(isinstance(m, ResBlock3D) for m in setup.eng.model.modules())
    assert len(calls) == 2 * n_blocks
    calls.clear()
    with torch.no_grad():
        setup.eng.diffusion_loss(torch.zeros(T, LH, LW, 4),
                                 {k: torch.from_numpy(v) for k, v in setup.cond.items()})
    assert len(calls) == n_blocks


def test_host_level_loss_runs_the_conditioner_with_ucg(setup):
    """``loss`` (engine.py:497-505): conditioning with ucg dropout from the
    generator, then the training loss with gradients to the network."""
    eng = setup.eng
    data = np.random.default_rng(5)
    batch = {"txt": ["a car"], "jpg": data.uniform(-1, 1, (1, T, 16, 192, 3)),
             "cond_img": data.uniform(0, 1, (1, T, 16, 192, 19)).astype(np.float32),
             "final_cond_zero": data.uniform(-1, 1, (1, T, 16, 192, 3)).astype(np.float32)}
    trained = eng.set_trainable()
    loss = eng.loss(batch, generator=torch.Generator().manual_seed(0))
    assert loss.ndim == 0 and torch.isfinite(loss) and loss.requires_grad
    loss.backward()
    assert all(p.grad is not None for p in trained.values())
    for p in trained.values():
        p.grad = None


def test_spatial_freeze_mask_selects_the_jax_set(setup):
    jeng, eng = setup.jeng, setup.eng
    for freeze in ("spatial", "none"):
        jeng.freeze_type = eng.freeze_type = freeze
        jmask = jeng.trainable_mask(jeng.params["model"])
        ones = jax.tree.map(lambda m, p: np.full(np.shape(p), float(m), np.float32), jmask,
                            jeng.params["model"])
        want = {k: bool(v.all()) for k, v in _to_port(jeng, ones).items()}
        assert all(v.all() or not v.any() for v in _to_port(jeng, ones).values())
        got = eng.trainable_mask()
        assert got == want
        trained = eng.set_trainable()
        assert sorted(trained) == sorted(k for k, v in want.items() if v)
        assert not any(p.requires_grad for p in eng.first_stage_model.parameters())
        assert not any(p.requires_grad for p in eng.conditioner.parameters())
    assert 0 < sum(want.values()) == len(want)
    jeng.freeze_type = eng.freeze_type = "none"


@pytest.mark.parametrize("freeze,spatial_lr_rate,schedule,grad_scale", [
    ("none", None, False, 1.0),       # grads below the clip norm
    ("none", None, False, 1e3),       # clipped
    ("spatial", None, False, 1e3),    # frozen parameters: no update, not in the norm
    ("none", 0.1, True, 1e3),         # dual LR groups, each clipped, and a schedule
])
def test_optimizer_and_ema_steps_match_optax(setup, freeze, spatial_lr_rate, schedule,
                                             grad_scale):
    jeng, eng = setup.jeng, setup.eng
    jeng.freeze_type = eng.freeze_type = freeze
    params = jeng.params["model"]
    rng = np.random.default_rng(3)
    grads = [jax.tree.map(lambda p: (grad_scale * 1e-3 * rng.standard_normal(np.shape(p))
                                     ).astype(np.float32), params) for _ in range(2)]
    sched_args = dict(warm_up_steps=1, lr_min=0.1, lr_max=1.0, lr_start=0.5, max_decay_steps=4)
    lr = 1e-3
    mask = jeng.trainable_mask(params)
    jopt = jax_make_optimizer(
        lr=lr, trainable_mask=mask, grad_clip=1.0, spatial_lr_rate=spatial_lr_rate,
        lr_schedule=jax_lr.LambdaWarmUpCosineScheduler(**sched_args) if schedule else None)
    jstate, jparams, jema = jopt.init(params), params, ema_init(params)
    for g in grads:
        upd, jstate = jopt.update(g, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        jema = ema_update(jema, jparams)

    trained = eng.trainable_mask()
    start = _to_port(jeng, params)
    masters = {k: v.clone() for k, v in start.items() if trained[k]}
    opt = AdamW(masters, lr=lr, grad_clip=1.0, spatial_lr_rate=spatial_lr_rate,
                lr_schedule=lr_schedule.LambdaWarmUpCosineScheduler(**sched_args)
                if schedule else None)
    ema = LitEma(masters)
    for g in grads:
        opt.step(masters, _to_port(jeng, g))
        ema.update(masters)
    want, want_ema = _to_port(jeng, jparams), _to_port(jeng, jema.ema_params)
    # fp32 on both sides, the same formulas in another rounding order
    for k, v in want.items():
        if trained[k]:
            torch.testing.assert_close(masters[k], v, rtol=1e-6, atol=1e-6)
            torch.testing.assert_close(ema.shadows[k], want_ema[k], rtol=1e-6, atol=1e-6)
        else:  # frozen: optax leaves it exactly as it was
            assert torch.equal(v, start[k]), k
    assert opt.count == 2 and ema.num_updates == 2
    jeng.freeze_type = eng.freeze_type = "none"


def test_sigma_samplers_match_jax():
    for flip, zero in ((True, False), (False, True)):
        cfg = {"discretization_config": DDPM, "num_idx": 1000, "do_append_zero": zero,
               "flip": flip}
        j, p = jax_sigma.DiscreteSampling(**cfg), sigma_sampling.DiscreteSampling(**cfg)
        np.testing.assert_allclose(p.sigmas_np, np.asarray(j.sigmas), rtol=1e-6)
        idx = np.random.default_rng(0).integers(0, 1000, 16)
        np.testing.assert_allclose(p(16, rand=torch.from_numpy(idx)).numpy(),
                                   np.asarray(j(16, rand=jnp.asarray(idx))), rtol=1e-6)
    g = torch.Generator().manual_seed(0)
    drawn = sigma_sampling.DiscreteSampling(DDPM, 1000)(64, generator=g)
    assert drawn.shape == (64,) and torch.isin(drawn, torch.from_numpy(
        sigma_sampling.DiscreteSampling(DDPM, 1000).sigmas_np)).all()
    rand = np.random.default_rng(1).standard_normal(8).astype(np.float32)
    np.testing.assert_allclose(
        sigma_sampling.EDMSampling(-1.0, 1.5)(8, rand=torch.from_numpy(rand)).numpy(),
        np.asarray(jax_sigma.EDMSampling(-1.0, 1.5)(8, rand=jnp.asarray(rand))), rtol=1e-6)


@pytest.mark.parametrize("kind,offset", [("l2", 0.0), ("l1", 0.0), ("l2", 0.1)])
def test_standard_diffusion_loss_matches_jax(setup, kind, offset):
    """Injected sigmas and noise, shared noise 0.07 toward the conditioning
    frame, the real denoisers and a fixed elementwise network."""
    cfg = dict(sigma_sampler_config={
        "target": "sgm.modules.diffusionmodules.sigma_sampling.DiscreteSampling",
        "params": {"num_idx": 1000, "discretization_config": DDPM}},
        type=kind, offset_noise_level=offset, share_noise_level=0.07, num_frames=T)
    from panacea_tpu.diffusion.loss import StandardDiffusionLoss as JaxLoss

    jloss, ploss = JaxLoss(**cfg), StandardDiffusionLoss(**cfg)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2 * T, 4, 6, 4)).astype(np.float32)
    concat = rng.standard_normal((2 * T, 4, 6, 4)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    k_sigma, k_noise, k_offset = jax.random.split(key, 3)
    idx = np.asarray(jax.random.randint(k_sigma, (2 * T,), 0, 1000))
    noise = np.asarray(jax.random.normal(k_noise, x.shape))
    off = np.asarray(jax.random.normal(k_offset, (2 * T,)))

    def jnet(xx, c_noise, cond):
        return jnp.tanh(xx) * 0.5 + c_noise.astype(jnp.float32)[:, None, None, None] * 1e-3

    def pnet(xx, c_noise, cond):
        return torch.tanh(xx) * 0.5 + c_noise.float()[:, None, None, None] * 1e-3

    want = jloss(jnet, setup.jeng.denoiser, {"concat": jnp.asarray(concat)}, jnp.asarray(x), key)
    got = ploss(pnet, setup.eng.denoiser, {"concat": torch.from_numpy(concat)},
                torch.from_numpy(x), sigma_rand=torch.from_numpy(idx),
                noise=torch.from_numpy(noise), offset=torch.from_numpy(off))
    assert got.shape == (2 * T,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5)
    with pytest.raises(ValueError, match="lpips"):
        StandardDiffusionLoss(**dict(cfg, type="lpips"))(
            pnet, setup.eng.denoiser, {"concat": torch.from_numpy(concat)},
            torch.from_numpy(x), sigma_rand=torch.from_numpy(idx), noise=torch.from_numpy(noise),
            offset=torch.from_numpy(off))


def test_ucg_dropout_gives_the_jax_conditioning(setup):
    """With ucg_rate 0.5 on the text embedder and the JAX keep mask injected,
    the port's conditioning dict equals the JAX one (the conditioning frames'
    posterior noise replayed from the JAX engine's default key)."""
    jeng, eng = setup.jeng, setup.eng
    b, ih, iw = 4, 16, 192
    data = np.random.default_rng(4)
    batch = {"txt": ["a car", "a bus at night", "rain", ""],
             "cond_img": data.uniform(0, 1, (b, T, ih, iw, 19)).astype(np.float32),
             "final_cond_zero": data.uniform(-1, 1, (b, T, ih, iw, 3)).astype(np.float32)}
    for emb in (jeng.conditioner.embedders[0], eng.conditioner.embedders[0]):
        emb.ucg_rate = 0.5
    try:
        for seed in range(20):  # a key whose mask keeps some rows and drops others
            key = jax.random.PRNGKey(seed)
            keep = np.asarray(jax.random.bernoulli(jax.random.split(key)[1], 0.5, (b,)))
            if 0 < keep.sum() < b:
                break
        want = jeng.conditioner(batch, rng=key, apply_ucg=True)
        post = np.concatenate([np.asarray(jax.random.normal(k, (1, ih // 8, iw // 8, 4)))
                               for k in jax.random.split(jax.random.PRNGKey(0), b * T)])
        vae = eng.conditioner.embedders[2]
        vae.encode_fn = lambda x: eng.encode_first_stage(x, noise=torch.from_numpy(post))
        with torch.no_grad():
            got = eng.conditioner(batch, "cpu", apply_ucg=True,
                                  ucg_keep={"txt": torch.from_numpy(keep.astype(np.float32))})
            nomask = eng.conditioner(batch, "cpu", apply_ucg=False)
    finally:
        for emb in (jeng.conditioner.embedders[0], eng.conditioner.embedders[0]):
            emb.ucg_rate = 0.1
        vae.encode_fn = eng.encode_first_stage
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-4, rtol=0,
                                   err_msg=k)
    assert not got["crossattn"][~torch.from_numpy(keep)].any()
    assert got["crossattn"][torch.from_numpy(keep)].abs().sum() > 0
    torch.testing.assert_close(got["concat"], nomask["concat"])  # rate 0: untouched
    # drawn from a generator: one Bernoulli keep per row, at the configured rate
    from panacea_tpu_torch.models.conditioner import GeneralConditioner

    text = dict(TINY_CPU["model"]["params"]["conditioner_config"]["params"]["emb_models"][0],
                ucg_rate=0.25)
    g = torch.Generator().manual_seed(0)
    cond = GeneralConditioner([text])
    with torch.no_grad():
        # the text tower's parameters start as torch.empty: give them finite
        # values, or a NaN left in that memory zeroes no row and keeps none
        init = torch.Generator().manual_seed(1)
        for p in cond.parameters():
            p.copy_(torch.randn(p.shape, generator=init) * 0.02)
        drawn = cond({"txt": ["x"] * 400}, "cpu", generator=g, apply_ucg=True)
    kept = (drawn["crossattn"].abs().sum(dim=(1, 2)) > 0).float().mean().item()
    assert 0.68 < kept < 0.82


def test_lr_schedules_match_jax():
    args = dict(warm_up_steps=10, lr_min=0.01, lr_max=1.0, lr_start=0.1, max_decay_steps=100)
    cyc = dict(warm_up_steps=[5, 10], f_min=[0.1, 0.2], f_max=[1.0, 0.8],
               f_start=[0.0, 0.3], cycle_lengths=[50, 80])
    for name, kw in (("LambdaWarmUpCosineScheduler", args),
                     ("LambdaWarmUpCosineScheduler2", cyc), ("LambdaLinearScheduler", cyc)):
        j, p = getattr(jax_lr, name)(**kw), getattr(lr_schedule, name)(**kw)
        for n in (0, 1, 4, 5, 9, 10, 11, 37, 50, 51, 99, 100, 129, 130, 131, 500):
            assert p(n) == pytest.approx(float(j(n)), rel=1e-12, abs=1e-12), (name, n)


def test_cli_resumes_exactly_and_hands_over_to_inference(tmp_path):
    """4 steps with checkpoints at 2 and 4, against 2 steps resumed from
    iter_2: bit-equal parameters, EMA and optimizer; the final engine
    checkpoint loads into the inference CLI with strict=True."""
    common = ["--tiny", "--synthetic", "--steps", "4", "--ckpt_every", "2", "--use_ema",
              "--device", "cpu", "--log_every", "1"]
    full = train.main(common + ["--ckpt_dir", str(tmp_path / "a")])
    os.makedirs(tmp_path / "b")
    shutil.copytree(tmp_path / "a" / "iter_2", tmp_path / "b" / "iter_2")
    resumed = train.main(common + ["--ckpt_dir", str(tmp_path / "b"),
                                   "--resume", str(tmp_path / "b" / "iter_2")])
    assert len(full["losses"]) == 4 and resumed["losses"] == full["losses"][2:]
    for k, v in full["state"].params.items():
        assert torch.equal(v, resumed["state"].params[k]), k
        assert torch.equal(full["state"].ema.shadows[k], resumed["state"].ema.shadows[k]), k
        assert torch.equal(full["state"].optimizer.nu[k], resumed["state"].optimizer.nu[k]), k
    assert sorted(os.listdir(tmp_path / "a")) == ["engine_final.ckpt", "final.pt",
                                                  "final_ema.pt", "iter_2", "iter_4"]
    from panacea_tpu_torch import inference

    out = inference.main(["--synthetic", "--tiny", "--device", "cpu", "--num_batches", "1",
                          "--num_steps", "2", "--outdir", str(tmp_path / "inf"),
                          "--ckpt", full["engine_ckpt"], "--prefer_ema"])
    assert out["done"] == 1
    sd = checkpoint.load_torch_checkpoint(full["engine_ckpt"])
    assert checkpoint.has_ema_weights(sd)


def test_checkpoint_rotation_keeps_the_newest(tmp_path, setup):
    from panacea_tpu_torch.train_step import init_train_state

    state = init_train_state(setup.eng, lr=1e-4)
    for step in range(1, 6):
        state.step = step
        checkpoint.save_train_checkpoint(str(tmp_path), state, setup.eng, max_keep=3)
    assert sorted(os.listdir(tmp_path)) == ["iter_3", "iter_4", "iter_5"]
    assert checkpoint.latest_checkpoint(str(tmp_path)).endswith("iter_5")
    assert checkpoint.is_train_checkpoint(str(tmp_path))
    state.step = 0
    meta = checkpoint.load_train_checkpoint(str(tmp_path), state, setup.eng)
    assert state.step == 5 and meta["path"].endswith("iter_5")


def test_cli_refuses_multi_device_options():
    for argv in (["--fsdp"], ["--dp", "2"]):
        with pytest.raises(SystemExit, match="Queue A item 8"):
            train.main(["--tiny", "--synthetic", "--device", "cpu"] + argv)


def _jax_cli():
    spec = importlib.util.spec_from_file_location("jax_train", os.path.join(ROOT, "train.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_cli_parser_has_the_jax_clis_flags_and_defaults():
    want = vars(_jax_cli().get_parser().parse_args([]))
    got = vars(train.get_parser().parse_args([]))
    assert got.pop("device") is None                     # the one flag beyond the JAX CLI's
    # the config by name, not the JAX package's YAML path (the port reads no
    # file of the JAX package)
    assert want.pop("base") == ["panacea_tpu/configs/inference_nuscenes.yaml"]
    assert got.pop("base") == ["inference_nuscenes"]
    assert got == want


def test_both_clis_pick_the_same_clips(monkeypatch, tmp_path):
    """The JAX CLI (its engine, optimizer, step and saves stubbed out) and
    the port's CLI read the same dataset items, step by step, for a seed."""
    import sys

    from panacea_tpu.data.nuscenes import dataset as jax_ds
    from panacea_tpu.models import conditioner as jax_cond
    from panacea_tpu.models import engine as jax_engine
    from panacea_tpu.parallel import train as jax_ptrain
    from panacea_tpu.utils import checkpoint as jax_ckpt
    from panacea_tpu.utils import jaxcache
    from panacea_tpu_torch import train_step
    from panacea_tpu_torch.data.nuscenes import dataset as port_ds

    class Done(Exception):
        pass

    def record(log):
        def getitem(self, i):
            log.append(int(i))
            return {}
        return getitem

    def stop(*a, **k):
        raise Done

    jax_read, port_read = [], []
    monkeypatch.setattr(jax_engine.DiffusionEngine3D, "init_params",
                        lambda self, *a, **k: setattr(self, "params",
                                                      {"model": {}, "first_stage": {}}))
    monkeypatch.setattr(jax_ptrain, "init_train_state",
                        lambda *a, **k: types.SimpleNamespace(params={}, opt_state=None, step=0,
                                                              ema=None))
    monkeypatch.setattr(jax_ptrain, "make_train_step", lambda *a, **k: lambda s, *b: (s, 0.0))
    monkeypatch.setattr(jax_ds.NuScenesVideoDataset, "__getitem__", record(jax_read))
    monkeypatch.setattr(jax_ds, "collate", lambda items: {"jpg": np.zeros(1)})
    monkeypatch.setattr(jax_cond.GeneralConditioner, "__call__", lambda self, *a, **k: {})
    monkeypatch.setattr(jax_ckpt, "save_pytree", stop)
    monkeypatch.setattr(jaxcache, "enable_persistent_cache", lambda *a, **k: None)
    argv = ["--tiny", "--synthetic", "--steps", "5", "--bs", "2", "--seed", "3",
            "--ckpt_dir", str(tmp_path)]
    monkeypatch.setattr(sys, "argv", ["train.py"] + argv)
    with pytest.raises(Done):
        _jax_cli().main()

    real = port_ds.NuScenesVideoDataset.__getitem__
    monkeypatch.setattr(port_ds.NuScenesVideoDataset, "__getitem__",
                        lambda self, i: port_read.append(int(i)) or real(self, i))
    monkeypatch.setattr(train_step, "train_step", lambda *a, **k: torch.tensor(0.0))
    monkeypatch.setattr(checkpoint, "save_engine_checkpoint", lambda *a, **k: "")
    train.main(argv + ["--device", "cpu", "--ckpt_every", "0"])
    assert len(jax_read) == 10 and port_read == jax_read
