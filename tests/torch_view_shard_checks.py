"""The sharded pieces of one clip over several ranks, each against one
process, run inside every rank of a gloo group (``tests/torch_dist_worker.py
--view_shard_checks DIR --view V``).

Every rank builds the same modules and inputs from the same seeds, computes
the one-process result itself, runs its own slab under the sharded context
and writes, for each case, the largest difference of its slab from the
one-process slab over the one-process result's largest value
(``DIR/checks_rank{R}.json``). fp32 on the CPU. Rank 0 also writes
``DIR/sample.pt``: the 8-frame tiny engine's latents sampled over the grid
from injected conditioning and noise, for the test to hold against the JAX
engine. ``run_ring`` (``--ring_checks DIR`` on 6 ranks) writes each rank's
ring outputs at V in {1, 2, 3, 6} (``DIR/ring_rank{R}.pt``) for the test to
hold against JAX ``ring_cross_view_attention``.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from panacea_tpu_torch.configs import TINY_CPU
from panacea_tpu_torch.data.nuscenes.dataset import NuScenesVideoDataset
from panacea_tpu_torch.data.nuscenes.synthetic import make_synthetic_infos, synthetic_image_loader
from panacea_tpu_torch.models.layers import Conv2d, GroupNorm, TemporalConv, TemporalGroupNorm
from panacea_tpu_torch.models.transformer import SpatialTemporalTransformer
from panacea_tpu_torch.parallel import comm_report, mesh, shardctx
from panacea_tpu_torch.parallel.ring_attention import ring_cross_view_attention
from panacea_tpu_torch.registry import instantiate_from_config
from panacea_tpu_torch.rollout import rollout

T = 4                   # the layers' frames
ENGINE_T = 8            # the 8-frame tiny engine
CLIPS = 2               # a CFG batch: two clips of T frames
H, W, C = 4, 24, 32     # 4 columns a view
ENGINE_HW = (16, 384)   # images of the tiny engine: a latent 2 x 48, 8 columns a view
STEPS = 2
RING_VIEWS = (1, 2, 3, 6)
RING_SHAPE = (6, 2, 16, 2, 8)   # (V, B, S, H, D) of tests/test_ring_attention.py


def engine_config() -> dict:
    """TINY_CPU at 8 frames."""
    cfg = json.loads(json.dumps(TINY_CPU["model"]))
    net = cfg["params"]["network_config"]["params"]
    net["num_frames"] = net["controlnet_config"]["params"]["num_frames"] = ENGINE_T
    return cfg


def tiny_engine():
    eng = instantiate_from_config(engine_config(), device="cpu")
    eng.init_weights(torch.Generator().manual_seed(0), zero_init_std=0.02)
    return eng


def engine_inputs(seed: int = 1):
    """(batch, injected cond, uc, noise) of the 8-frame tiny engine."""
    rng = np.random.default_rng(seed)
    ih, iw = ENGINE_HW
    jpg = rng.uniform(-1, 1, (1, ENGINE_T, ih, iw, 3)).astype(np.float32)
    fcz = np.zeros_like(jpg)
    fcz[:, -1] = jpg[:, -1]
    cond_img = rng.uniform(0, 1, (1, ENGINE_T, ih, iw, 19)).astype(np.float32)
    batch = {"jpg": jpg, "cond_img": cond_img, "final_cond_zero": fcz,
             "txt": ["a driving scene. daytime."]}
    lh, lw = ih // 8, iw // 8
    cond = {"crossattn": rng.standard_normal((1, 77, 64)),
            "concat": rng.standard_normal((ENGINE_T, lh, lw, 4)) * 0.5,
            "cond_feat": rng.uniform(0, 1, (ENGINE_T, ih, iw, 19))}
    uc = dict(cond, crossattn=np.zeros((1, 77, 64)))
    cond, uc = ({k: v.astype(np.float32) for k, v in c.items()} for c in (cond, uc))
    noise = rng.standard_normal((ENGINE_T, lh, lw, 4)).astype(np.float32)
    return batch, cond, uc, noise


def slab(x: torch.Tensor, g, frames: int, clips: int = CLIPS) -> torch.Tensor:
    """This rank's frames and columns of (clips * frames, H, W, C)."""
    tl, wl = frames // g.t, x.shape[2] // g.view
    x = x.reshape((clips, frames) + tuple(x.shape[1:]))
    x = x[:, g.t_index * tl:(g.t_index + 1) * tl, :, g.view_index * wl:(g.view_index + 1) * wl]
    return x.reshape((-1,) + tuple(x.shape[2:]))


def err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))


def both(g, fn, x):
    """(this rank's slab of ``fn``'s one-process output, its sharded output)."""
    with torch.no_grad():
        want = fn(x)
        with shardctx.sharded(g):
            got = fn(slab(x, g, T))
    return slab(want, g, T), got


def layer_cases(g) -> dict:
    torch.manual_seed(0)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((CLIPS * T, H, W, C)).astype(np.float32))
    ctx = torch.from_numpy(rng.standard_normal((CLIPS, 7, 16)).astype(np.float32))
    out = {}
    conv = Conv2d(C, 16, 3, padding=1)
    want, got = both(g, conv, x)
    out["conv_stride1"] = err(got, want)
    # the panorama's two end columns alone (zero padding, nothing wraps)
    ends = [i for i, col in enumerate(range(g.view_index * W // g.view,
                                            (g.view_index + 1) * W // g.view))
            if col in (0, W - 1)]
    out["conv_ends"] = err(got[:, :, ends], want[:, :, ends]) if ends else 0.0
    out["conv_ends_columns"] = len(ends)
    want, got = both(g, Conv2d(C, 16, 3, stride=2, padding=1), x)
    out["conv_stride2"] = err(got, want)
    gn = GroupNorm(C, num_groups=8)
    with torch.no_grad():
        gn.weight.normal_()
        gn.bias.normal_()
    want, got = both(g, lambda z: gn(z + 0.5, silu=True), x)
    out["groupnorm"] = err(got, want)
    tgn = TemporalGroupNorm(C, T, num_groups=8)
    want, got = both(g, lambda z: tgn(z * 2.0 + 1.0, silu=True), x)
    out["temporal_groupnorm"] = err(got, want)
    tconv = TemporalConv(C, T)
    with torch.no_grad():
        tconv.weight.normal_(std=0.2)
        tconv.bias.normal_()
    want, got = both(g, tconv, x)
    out["temporal_conv"] = err(got, want)
    stt = SpatialTemporalTransformer(C, 2, 16, 16, num_frames=T)
    with torch.no_grad():
        for p in stt.parameters():
            p.normal_(std=0.2)
    want, got = both(g, lambda z: stt.temporal_stage(z, ctx), x)
    out["temporal_stage"] = err(got, want)
    want, got = both(g, lambda z: stt(z, ctx), x)
    out["spatial_temporal_transformer"] = err(got, want)
    full = SpatialTemporalTransformer(C, 2, 16, 16, num_frames=T, spatial_attn_mode="full",
                                      insert_crossview=False)
    with torch.no_grad():
        for p in full.parameters():
            p.normal_(std=0.2)
    want, got = both(g, lambda z: full(z, ctx), x)
    out["full_mode_transformer"] = err(got, want)
    return out


def engine_cases(g, dump_dir: str) -> dict:
    eng = tiny_engine()
    batch, cond, uc, noise = engine_inputs()
    out = {}
    with torch.no_grad():
        want = eng.log_images(batch, N=1, generator=torch.Generator().manual_seed(3),
                              num_steps=STEPS)
        eng.set_grid(g)
        comm_report.reset()
        got = eng.log_images(batch, N=1, generator=torch.Generator().manual_seed(3),
                             num_steps=STEPS)
        out["exchanges"] = comm_report.summary()
        for k in ("samples", "reconstructions"):
            out[f"log_images_{k}"] = err(got[k], want[k])
        t = [{k: torch.from_numpy(v) for k, v in c.items()} for c in (cond, uc)]
        sample = eng.sample(t[0], uc=t[1], batch_size=ENGINE_T, shape=tuple(noise.shape[1:]),
                            noise=torch.from_numpy(noise), num_steps=STEPS)
        eng.set_grid(None)
        one = eng.sample(t[0], uc=t[1], batch_size=ENGINE_T, shape=tuple(noise.shape[1:]),
                         noise=torch.from_numpy(noise), num_steps=STEPS)
    out["sample_injected"] = err(sample, one)
    # Euler with churn: the per-step noise drawn at the clip's full shape
    # from the generator, each rank keeping its slab; and the trajectory
    eng.sampler.s_churn = 2.0
    with torch.no_grad():
        runs = []
        for grid in (g, None):
            eng.set_grid(grid)
            runs.append(eng.sample(t[0], uc=t[1], batch_size=ENGINE_T,
                                   shape=tuple(noise.shape[1:]),
                                   generator=torch.Generator().manual_seed(6), num_steps=STEPS,
                                   return_trajectory=True))
    eng.sampler.s_churn = 0.0
    out["sample_churn_trajectory"] = err(runs[0][1], runs[1][1])
    # the rollout's two windows, the second conditioned on the first's last frame
    def windows():   # a fresh dataset: its items draw from its own random state
        ds = NuScenesVideoDataset(infos=make_synthetic_infos(num_frames=2 * ENGINE_T, seed=0),
                                  queue_length=ENGINE_T,
                                  final_dim=(ENGINE_HW[0], ENGINE_HW[1] // 6),
                                  image_loader=synthetic_image_loader, seed=0)
        return rollout(eng, ds, ENGINE_T - 1, 2, generator=torch.Generator().manual_seed(4),
                       num_steps=1)["frames"]

    with torch.no_grad():
        want = windows()
        eng.set_grid(g)
        got = windows()
        eng.set_grid(None)
    out["rollout_frames"] = err(torch.from_numpy(got), torch.from_numpy(want))
    if g.rank == 0:
        torch.save({"latents": sample, "one_process": one}, os.path.join(dump_dir, "sample.pt"))
    return out


def run(dump_dir: str, view: int) -> None:
    """Every case on this rank of the default process group."""
    import torch.distributed as dist

    rank, world = dist.get_rank(), dist.get_world_size()
    g = mesh.make_grid(world, view, "cpu")
    out = {"grid": {"t": g.t, "view": g.view, "t_index": g.t_index,
                    "view_index": g.view_index}}
    os.makedirs(dump_dir, exist_ok=True)
    out.update(layer_cases(g))
    out.update(engine_cases(g, dump_dir))
    with open(os.path.join(dump_dir, f"checks_rank{rank}.json"), "w") as f:
        json.dump(out, f)


def ring_inputs():
    """q, k, v (V, B, S, H, D), the JAX ring's layout."""
    rng = np.random.default_rng(5)
    return [rng.standard_normal(RING_SHAPE).astype(np.float32) for _ in range(3)]


def run_ring(dump_dir: str) -> None:
    """This rank's ring outputs, (views of its slab, B, S, H, D), at each V
    and with and without the last-view quirk."""
    import torch.distributed as dist

    rank, world = dist.get_rank(), dist.get_world_size()
    q, k, v = (torch.from_numpy(a).transpose(0, 1) for a in ring_inputs())   # (B, V, ...)
    out = {}
    for view in RING_VIEWS:
        g = mesh.make_grid(world, view, "cpu")
        vl = mesh.NUM_VIEWS // view
        part = slice(g.view_index * vl, (g.view_index + 1) * vl)
        for quirk in (True, False):
            with torch.no_grad(), shardctx.sharded(g):
                o = ring_cross_view_attention(q[:, part], k[:, part], v[:, part], g,
                                              last_view_left_only=quirk)
            out[(view, quirk)] = {"view_index": g.view_index, "t_index": g.t_index,
                                  "out": o.transpose(0, 1).numpy()}
    os.makedirs(dump_dir, exist_ok=True)
    torch.save(out, os.path.join(dump_dir, f"ring_rank{rank}.pt"))
