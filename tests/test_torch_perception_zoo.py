"""The port's dense-attention PETR family (VoVNet, StreamPETRHead,
PETRHeadDN, PETRMotionHead and their detectors) against the JAX package's,
on the CPU.

Every parameter is drawn on the port's side (``torch_parity.draw``, then
batch-norm scales and variances in [0.5, 1.5] and reference points in
[0, 1]) and carried to the JAX modules by the JAX package's own
``convert_streampetr_checkpoint`` (the backbone alone through
``convert.vovnet_map`` walked backwards). The inputs are numpy arrays from
a seed. Tolerances are stated per test: fp32 on both sides, in another
order of summation. Torch and BLAS run on two threads.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_perception import close, frame_data, sub_state, torch_tree
from test_torch_perception_train import PC, T, dn_noise, gt_batch
from torch_parity import draw, to_jax, two_threads  # noqa: F401

from panacea_tpu.perception import coder as jcoder
from panacea_tpu.perception import denoise as jdenoise
from panacea_tpu.perception import detector as jdetector
from panacea_tpu.perception import motion_head as jmotion
from panacea_tpu.perception.head import init_memory as jinit_memory
from panacea_tpu.perception.petr_head import StreamPETRHead as JStreamPETRHead
from panacea_tpu.perception.petr_head_dn import PETRHeadDN as JPETRHeadDN
from panacea_tpu.perception.vovnet import VoVNet as JVoVNet
from panacea_tpu.utils.convert import convert_streampetr_checkpoint
from panacea_tpu_torch import convert
from panacea_tpu_torch.convert import streampetr_state_dict_from_jax
from panacea_tpu_torch.ops import attention as port_attention
from panacea_tpu_torch.perception import coder, denoise, detector, motion_head
from panacea_tpu_torch.perception.head import init_memory
from panacea_tpu_torch.perception.petr_head import StreamPETRHead
from panacea_tpu_torch.perception.petr_head_dn import PETRHeadDN
from panacea_tpu_torch.perception.resnet import FrozenBatchNorm
from panacea_tpu_torch.perception.vovnet import VoVNet

pytestmark = pytest.mark.usefixtures("two_threads")
TINY = dict(embed_dims=32, num_query=12, memory_len=24, topk_proposals=8, num_propagated=8,
            num_decoder_layers=2, num_cams=6)
TINY_VOV = dict(stage_ch=(16, 16, 16, 16), concat_ch=(32, 32, 64, 64), num_blocks=(1, 1, 2, 1),
                num_layers=2)
BLOCKS = (1, 1, 1, 1)


def drawn(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Every tensor drawn (``draw``), then the batch-norm scales and
    variances in [0.5, 1.5] and the reference points in [0, 1]."""
    draw(module, seed)
    rng = np.random.default_rng(seed + 1)
    with torch.no_grad():
        for name, mod in module.named_modules():
            if isinstance(mod, FrozenBatchNorm):
                for t in (mod.weight, mod.running_var):
                    t.copy_(T(rng.uniform(0.5, 1.5, t.shape).astype(np.float32)))
            elif name.endswith("reference_points"):
                mod.weight.copy_(T(rng.uniform(0, 1, mod.weight.shape).astype(np.float32)))
    return module


def to_jax_detector(sd, backbone="r50", head="petr"):
    """The JAX tree of a port state dict through the JAX converter; the
    report's unexpected names must be none."""
    params, report = convert_streampetr_checkpoint(
        {k: v.numpy() for k, v in sd.items()}, num_layers=2, stage_blocks=BLOCKS,
        backbone=backbone, head=head)
    assert report["unexpected"] == [], report["unexpected"][:5]
    return params, report


def head_inputs(rng, b, n, h, w, c, frames, levels=(8,)):
    data = frame_data(rng, b, frames, n, h, w)
    feats = [[rng.standard_normal((b, n, h // s, w // s, c)).astype(np.float32) for s in levels]
             for _ in range(frames)]
    return data, feats


def port_feats(fs):
    return [T(f).flatten(0, 1).permute(0, 3, 1, 2) for f in fs]


def test_vovnet_matches_jax():
    """VoVNet at the JAX tests' tiny widths (two convolutions a block, two
    blocks in the third stage, so one identity block) on two 64 x 128
    images: every stage within 1e-5 of its largest value."""
    x = np.random.default_rng(1).standard_normal((2, 64, 128, 3)).astype(np.float32)
    vov = drawn(VoVNet(**TINY_VOV), 2)
    params = to_jax(vov, convert.vovnet_map("n", (), TINY_VOV["num_blocks"],
                                            TINY_VOV["num_layers"]))
    jvov = JVoVNet(**TINY_VOV)
    want = jax.jit(lambda p, v: jvov.apply({"params": p}, v))(params, jnp.asarray(x))
    with torch.no_grad():
        got = vov(T(x).permute(0, 3, 1, 2).contiguous())
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        close(g.permute(0, 2, 3, 1).numpy(), w, 1e-5)


def test_stream_petr_head_two_frames_on_the_flash_route_matches_jax(monkeypatch):
    """The production head width (embed 256, 8 heads of dim 32) with 100
    queries, 32 propagated and a 200-slot memory, 2 layers, depth_num 32,
    over 2 frames of 2 cameras: each layer's self-attention (Sq 132, Skv
    300) and dense cross-attention (Sq 132 to 2 x 8 x 16 = 256 tokens) are
    routed to ``flash_attention`` (its plain version on the CPU). Scores,
    boxes and the memory within 1e-4 of their largest value."""
    rng = np.random.default_rng(6)
    b, n, h, w, c = 1, 2, 64, 128, 256
    cfg = dict(embed_dims=c, num_query=100, memory_len=200, topk_proposals=32,
               num_propagated=32, num_decoder_layers=2, num_levels=1, num_cams=n)
    data, feats = head_inputs(rng, b, n, h, w, c, 2)
    head = drawn(StreamPETRHead(depth_num=32, **cfg), 7)
    params, _ = to_jax_detector({f"pts_bbox_head.{k}": v for k, v in head.state_dict().items()})
    jhead = JStreamPETRHead(depth_num=32, **cfg)
    run = jax.jit(lambda p, f, m, d: jhead.apply({"params": p}, f, m, d, (h, w)))
    jmem = jinit_memory(b, 200, c)
    for fi in range(2):
        jouts, jmem = run(params["head"], [jnp.asarray(f) for f in feats[fi]], jmem,
                          {k: jnp.asarray(v[:, fi]) for k, v in data.items()})

    calls, flash = [], port_attention.flash_attention

    def counted(q, k, v, **kw):
        calls.append((q.shape[1], k.shape[1], q.shape[3]))
        return flash(q, k, v, **kw)

    monkeypatch.setattr(port_attention, "flash_attention", counted)
    mem = init_memory(b, 200, c)
    with torch.no_grad():
        for fi in range(2):
            outs, mem = head(port_feats(feats[fi]), mem,
                             {k: T(v[:, fi]) for k, v in data.items()}, (h, w))
    assert calls == [(132, 300, 32), (132, 256, 32)] * 4
    for key in ("all_cls_scores", "all_bbox_preds"):
        close(outs[key].numpy(), jouts[key], 1e-4)
    for field in jmem._fields:
        close(getattr(mem, field).numpy(), getattr(jmem, field), 1e-4)


def test_stream_petr_head_with_dn_and_injected_top_k_matches_jax():
    """The tiny head on one frame (batch 2, 3 cameras, LID depth bins) with
    a DNPack and an injected ``topk_indexes`` that keeps 40 of the 3 x 8 x
    16 tokens in a shuffled order: the DN and match slices and the memory
    within 1e-4."""
    rng = np.random.default_rng(8)
    b, n, h, w, c = 2, 3, 32, 64, 32
    cfg = dict(TINY, num_levels=1, num_cams=n, depth_num=32, lid=True)
    data, feats = head_inputs(rng, b, n, h, w, c, 1, levels=(4,))
    topk = np.stack([rng.permutation(n * 8 * 16)[:40] for _ in range(b)])[..., None]
    boxes, labels = gt_batch(rng, b, 3, [3, 1])
    key = jax.random.PRNGKey(9)
    jpack = jdenoise.prepare_dn(key, jnp.asarray(boxes), jnp.asarray(labels), num_query=12,
                                num_propagated=8, memory_len=24, pc_range=PC, scalar=10)
    pack = denoise.prepare_dn(T(boxes), T(labels), num_query=12, num_propagated=8,
                              memory_len=24, pc_range=PC, scalar=10,
                              rand_prob=T(dn_noise(key, b, 30).copy()))
    head = drawn(StreamPETRHead(**cfg), 10)
    params, _ = to_jax_detector({f"pts_bbox_head.{k}": v for k, v in head.state_dict().items()})
    d0 = {k: v[:, 0] for k, v in data.items()}
    jhead = JStreamPETRHead(**cfg)
    jouts, jmem = jax.jit(lambda p, f, d: jhead.apply(
        {"params": p}, f, jinit_memory(b, 24, c), d, (h, w), dn=jpack,
        topk_indexes=jnp.asarray(topk)))(params["head"], [jnp.asarray(f) for f in feats[0]],
                                         {k: jnp.asarray(v) for k, v in d0.items()})
    with torch.no_grad():
        outs, mem = head(port_feats(feats[0]), init_memory(b, 24, c), torch_tree(d0), (h, w),
                         dn=pack, topk_indexes=T(topk))
    assert outs.keys() == jouts.keys() and outs["dn_cls_scores"].shape == (2, b, 30, 10)
    for k in jouts:
        close(outs[k].numpy(), jouts[k], 1e-4)
    for field in jmem._fields:
        close(getattr(mem, field).numpy(), getattr(jmem, field), 1e-4)


def test_petr_head_dn_matches_jax_without_memory_towers(monkeypatch):
    """PETRHeadDN at embed 256 with 140 queries on one frame of 2 cameras:
    no memory parameters, the memory passed through, the self-attention
    (Sq = Skv = 140) on SDPA and the cross-attention on ``flash_attention``;
    scores and boxes within 1e-4."""
    rng = np.random.default_rng(11)
    b, n, h, w, c = 1, 2, 64, 128, 256
    cfg = dict(embed_dims=c, num_query=140, memory_len=200, topk_proposals=32,
               num_propagated=32, num_decoder_layers=2, num_levels=1, num_cams=n, depth_num=32)
    data, feats = head_inputs(rng, b, n, h, w, c, 1)
    head = drawn(PETRHeadDN(**cfg), 12)
    sd = head.state_dict()
    assert not any(k.startswith(("pseudo_reference_points", "time_embedding", "ego_pose"))
                   for k in sd)
    params, report = to_jax_detector({f"pts_bbox_head.{k}": v for k, v in sd.items()},
                                     head="petr_dn")
    d0 = {k: v[:, 0] for k, v in data.items()}
    jhead = JPETRHeadDN(**cfg)
    jouts, _ = jax.jit(lambda p, f, d: jhead.apply({"params": p}, f, jinit_memory(b, 200, c),
                                                   d, (h, w)))(
        params["head"], [jnp.asarray(f) for f in feats[0]],
        {k: jnp.asarray(v) for k, v in d0.items()})
    calls, flash = [], port_attention.flash_attention
    monkeypatch.setattr(port_attention, "flash_attention",
                        lambda q, k, v, **kw: calls.append(k.shape[1]) or flash(q, k, v, **kw))
    mem = init_memory(b, 200, c)
    with torch.no_grad():
        outs, mem_out = head(port_feats(feats[0]), mem, torch_tree(d0), (h, w))
    assert calls == [256, 256] and mem_out is mem
    for key in ("all_cls_scores", "all_bbox_preds"):
        close(outs[key].numpy(), jouts[key], 1e-4)


def test_motion_head_trajectories_loss_and_decode_match_jax():
    """PETRMotionHead (tiny, 4 steps, 3 modes) over one frame: boxes,
    trajectories and mode scores of every layer within 1e-4; then
    ``traj_targets_from_assignment``, ``traj_loss_v1`` (rows with no valid
    step, partial validity) and ``decode_with_traj`` on those outputs
    against the JAX functions."""
    rng = np.random.default_rng(13)
    b, n, h, w, c = 2, 2, 32, 64, 32
    cfg = dict(TINY, num_levels=1, num_cams=n, depth_num=32, pred_steps=4, mode=3)
    data, feats = head_inputs(rng, b, n, h, w, c, 1, levels=(4,))
    head = drawn(motion_head.PETRMotionHead(**cfg), 14)
    params, _ = to_jax_detector({f"pts_bbox_head.{k}": v for k, v in head.state_dict().items()},
                                head="motion")
    d0 = {k: v[:, 0] for k, v in data.items()}
    jhead = jmotion.PETRMotionHead(**cfg)
    jouts, _ = jax.jit(lambda p, f, d: jhead.apply({"params": p}, f, jinit_memory(b, 24, c), d,
                                                   (h, w)))(
        params["head"], [jnp.asarray(f) for f in feats[0]],
        {k: jnp.asarray(v) for k, v in d0.items()})
    with torch.no_grad():
        outs, _ = head(port_feats(feats[0]), init_memory(b, 24, c), torch_tree(d0), (h, w))
    assert outs["all_traj_preds"].shape == (2, b, 20, 3, 4, 2)
    for k in jouts:
        close(outs[k].numpy(), jouts[k], 1e-4)

    q, m, s, g = 20, 3, 4, 5
    gt = rng.normal(0, 5, (g, s, 2)).astype(np.float32)
    gmask = (rng.random((g, s, 2)) < 0.7).astype(np.float32)
    gmask[0] = 0.0                                     # a ground truth with no valid step
    pos = rng.random(q) < 0.5
    assigned = np.where(pos, rng.integers(0, g, q), -1)
    tg, tw = motion_head.traj_targets_from_assignment((q, m, s, 2), T(pos), T(assigned), T(gt),
                                                      T(gmask))
    jtg, jtw = jmotion.traj_targets_from_assignment((q, m, s, 2), jnp.asarray(pos),
                                                    jnp.asarray(assigned), jnp.asarray(gt),
                                                    jnp.asarray(gmask))
    np.testing.assert_array_equal(tg.numpy(), jtg)
    np.testing.assert_array_equal(tw.numpy(), jtw)
    prob, preds = outs["all_traj_scores"][-1], outs["all_traj_preds"][-1]
    gt_b, w_b = tg.repeat(b, 1, 1, 1), tw.repeat(b, 1, 1, 1)
    got = motion_head.traj_loss_v1(prob, preds, gt_b, w_b, avg_factor=float(pos.sum()))
    want = jax.jit(jmotion.traj_loss_v1)(jnp.asarray(prob.numpy()), jnp.asarray(preds.numpy()),
                                         jnp.asarray(gt_b.numpy()), jnp.asarray(w_b.numpy()),
                                         float(pos.sum()))
    close(got.numpy(), want, 1e-5)
    pc = PC
    got_dec = motion_head.decode_with_traj(coder.NMSFreeCoder(pc_range=pc, max_num=10), outs,
                                           max_modes=2)
    want_dec = jmotion.decode_with_traj(jcoder.NMSFreeCoder(pc_range=pc, max_num=10), jouts,
                                        max_modes=2)
    for gd, wd in zip(got_dec, want_dec):
        np.testing.assert_array_equal(gd["box_idx"], wd["box_idx"])
        assert gd["trajs"].shape == (len(wd["box_idx"]), 2, 4, 2)
        close(gd["trajs"], wd["trajs"], 1e-4)
        close(gd["traj_scores"], wd["traj_scores"], 1e-4)


def test_tiny_vovnet_petr_window_through_decode_matches_jax():
    """``PetrWindow3D`` with the tiny VoVNet (the neck from its third
    stage), the tiny StreamPETRHead and 6 cameras over a 2-frame window,
    then ``NMSFreeCoder.decode``: the same boxes in the same order, labels
    equal, scores and boxes within 1e-4 of their largest value."""
    rng = np.random.default_rng(15)
    b, t, n, h, w = 1, 2, 6, 64, 128
    imgs = rng.standard_normal((b, t, n, h, w, 3)).astype(np.float32)
    data = frame_data(rng, b, t, n, h, w)
    kw = dict(backbone_type="vovnet", backbone_cfg=TINY_VOV, neck_start_level=2, **TINY)
    model = drawn(detector.PetrWindow3D(**kw), 16)
    assert isinstance(model.pts_bbox_head, StreamPETRHead)
    params, _ = to_jax_detector(model.state_dict(), backbone="vovnet")
    jmodel = jdetector.PetrWindow3D(**kw)
    jouts, _ = jax.jit(lambda p, i, d: jmodel.apply({"params": p}, i, d))(
        params, jnp.asarray(imgs), {k: jnp.asarray(v) for k, v in data.items()})
    with torch.no_grad():
        outs, _ = model(T(imgs), torch_tree(data))
    want = jcoder.NMSFreeCoder(pc_range=PC, max_num=20).decode(jouts)[0]
    got = coder.NMSFreeCoder(pc_range=PC, max_num=20).decode(outs)[0]
    assert len(want["labels"]) > 10
    np.testing.assert_array_equal(got["labels"], want["labels"])
    np.testing.assert_array_equal(got["box_idx"], want["box_idx"])
    close(got["scores"], want["scores"], 1e-4)
    close(got["bboxes"], want["bboxes"], 1e-4)


@pytest.mark.parametrize("backbone, head", [("vovnet", "petr"), ("r50", "petr_dn"),
                                            ("vovnet", "motion"), ("vovnet", "sparse")])
def test_state_dicts_round_trip_through_the_jax_converter(backbone, head):
    """The port detector's state dict through ``convert_streampetr_checkpoint``
    and back through ``streampetr_state_dict_from_jax``: every tensor equal,
    none unexpected; the only names the JAX converter misses are its own
    VoVNet-99 blocks beyond the tiny VoVNet's and, for petr_dn, the memory
    towers that the head does not have."""
    kw = dict(TINY, backbone_type=backbone, head_type=head,
              neck_start_level={"r50": 1, "vovnet": 2}[backbone],
              backbone_cfg=TINY_VOV if backbone == "vovnet" else {"stage_blocks": BLOCKS})
    model = drawn(detector.StreamPETRWindow(**kw), 17)
    sd = model.state_dict()
    params, report = to_jax_detector(sd, backbone, head)
    for name in report["missing"]:
        assert (name.startswith("img_backbone.stage") and name not in sd
                or head == "petr_dn" and name.startswith(
                    ("pts_bbox_head.pseudo", "pts_bbox_head.time_embedding",
                     "pts_bbox_head.ego_pose"))), name
    back = streampetr_state_dict_from_jax(params, num_layers=2, stage_blocks=BLOCKS,
                                          backbone=backbone, head=head)
    assert back.keys() == sd.keys()
    for k in sd:
        assert torch.equal(back[k], sd[k]), k


def test_detector_drivers_take_their_heads():
    """The JAX package's drivers: PetrWindow3D, Petr3D and Petr3DM carry
    StreamPETRHead, Petr3DP PETRMotionHead; the streaming ones stream."""
    heads = {detector.PetrWindow3D: StreamPETRHead, detector.Petr3D: StreamPETRHead,
             detector.Petr3DM: StreamPETRHead, detector.Petr3DP: motion_head.PETRMotionHead}
    for cls, head in heads.items():
        model = cls(backbone_cfg={"stage_blocks": BLOCKS}, **TINY)
        assert type(model.pts_bbox_head) is head
        assert hasattr(model, "stream") == (cls is not detector.PetrWindow3D)
    assert sub_state(detector.Petr3DP(backbone_cfg={"stage_blocks": BLOCKS}, **TINY).state_dict(),
                     "pts_bbox_head.traj_branches.0.").keys() == {
        f"{j}.{p}" for j in (0, 2, 4) for p in ("weight", "bias")}
