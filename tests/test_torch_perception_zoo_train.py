"""Training the dense-attention PETR family with the port, against the JAX
package, on the CPU: the ground truth's future trajectories and the
training windows that carry them, the loss with the motion head's
trajectory term, the gradients of the dense cross-attention (on the flash
route) and of the trajectory loss, the frozen VoVNet set, PETRHeadDN with
its denoising queries, and the training CLI with the three detectors.

Nothing here differentiates the JAX detector: the loss is composed from
the JAX package's public loss functions on the port's outputs, and the
gradients held against ``jax.grad`` are single modules'. Inputs are numpy
arrays from seeds; tolerances are stated per test. Torch and BLAS run on
two threads.
"""

import copy
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from test_torch_perception import BLOCKS, close, frame_data, init_random, torch_tree
from test_torch_perception import TINY as TINY_HEAD
from test_torch_perception_train import PC, T, dn_noise, gt_batch
from test_torch_perception_zoo import TINY, TINY_VOV, drawn, head_inputs, port_feats
from torch_parity import to_jax, two_threads  # noqa: F401

from panacea_tpu.data.nuscenes import trajectory as jtrajectory
from panacea_tpu.data.nuscenes.synthetic import make_synthetic_infos as jax_infos
from panacea_tpu.perception import denoise as jdenoise
from panacea_tpu.perception import motion_head as jmotion
from panacea_tpu.perception import train as jtrain
from panacea_tpu.perception import train_losses as jlosses
from panacea_tpu.perception.coder import normalize_bbox as jnorm
from panacea_tpu.perception.head import init_memory as jinit_memory
from panacea_tpu.perception.petr_head import PETRCrossAttention as JPETRCrossAttention
from panacea_tpu.perception.petr_head_dn import PETRHeadDN as JPETRHeadDN
from panacea_tpu.perception.train_dataset import PerceptionTrainDataset as JTrainDataset
from panacea_tpu.utils.convert import convert_streampetr_checkpoint
from panacea_tpu_torch import convert
from panacea_tpu_torch.configs import PERCEPTION
from panacea_tpu_torch.convert import _dense, _packed_qkv, apply_map, flatten
from panacea_tpu_torch.data.nuscenes.synthetic import make_synthetic_infos
from panacea_tpu_torch.data.nuscenes.trajectory import future_trajectories
from panacea_tpu_torch.ops import flash_attention as port_flash
from panacea_tpu_torch.perception import atss, denoise, detector, motion_head, train, train_cli
from panacea_tpu_torch.perception.head import init_memory
from panacea_tpu_torch.perception.petr_head import PETRCrossAttention
from panacea_tpu_torch.perception.petr_head_dn import PETRHeadDN
from panacea_tpu_torch.perception.train_dataset import PerceptionTrainDataset
from panacea_tpu_torch.perception.vovnet import VoVNet

pytestmark = pytest.mark.usefixtures("two_threads")
WINDOW, STREAMING = "streampetr_r50_atss_512x256_window", "streampetr_r50_atss_512x256_nopretrain"
JAX_LOSS_KEYS = {"loss", "loss_cls", "loss_bbox", "loss_dn", "loss_atss_cls", "loss_atss_bbox",
                 "loss_atss_ctr"}


# ------------------------------------------------------------ trajectories


def two_scene_infos(make):
    """Two scenes of the synthetic generator (8 and 6 frames) with poses
    that turn and move, a lidar offset from the ego, and broken chains:
    instance 2 missing from frame 3 and instance 0 from frame 9."""
    rng = np.random.default_rng(3)
    infos = (make(num_frames=8, num_boxes=5, seed=1, scene_token="scene-a")
             + make(num_frames=6, num_boxes=4, seed=2, scene_token="scene-b"))
    for i, info in enumerate(infos):
        yaw = 0.1 * i + rng.uniform(-0.05, 0.05)
        info["ego2global_rotation"] = [math.cos(yaw / 2), 0.0, 0.0, math.sin(yaw / 2)]
        info["ego2global_translation"] = [3.0 * i, 0.5 * i, 0.0]
        info["lidar2ego_rotation"] = [math.cos(0.7), 0.0, 0.0, math.sin(0.7)]
        info["lidar2ego_translation"] = [0.9, 0.0, 1.8]
    for i, gone in ((3, 2), (9, 0)):
        keep = np.asarray(infos[i]["instance_inds"]) != gone
        for k in ("gt_boxes", "instance_inds", "valid_flag", "gt_names"):
            infos[i][k] = np.asarray(infos[i][k])[keep]
    return infos


def test_future_trajectories_match_jax_at_every_index():
    """``future_trajectories`` on two scenes with broken chains: every
    index, the futures within 1e-6 absolute and the masks equal; a future
    stops at the scene boundary and at the first frame without its
    instance."""
    ours, ref = two_scene_infos(make_synthetic_infos), two_scene_infos(jax_infos)
    for idx in range(len(ours)):
        got, got_mask = future_trajectories(ours, idx, pred_steps=12)
        want, want_mask = jtrajectory.future_trajectories(ref, idx, pred_steps=12)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(got_mask, want_mask)
    _, mask = future_trajectories(ours, 5, pred_steps=12)
    assert mask[:, :, 0].sum(1).tolist() == [2, 2, 2, 2, 2]     # scene a ends after frame 7
    _, mask = future_trajectories(ours, 1, pred_steps=12)
    assert mask[:, :, 0].sum(1).tolist() == [6, 6, 1, 6, 6]     # instance 2 lost at frame 3


@pytest.mark.parametrize("augment", [False, True])
def test_window_with_gt_trajectories_equal_jax(augment):
    """``window_with_gt(pred_steps=12)`` of the port and of the JAX dataset
    on the same infos, with and without the global rotation and scale (the
    draws of one RandomState seed on each side): the window, the boxes,
    ``gt_trajs`` and ``gt_traj_mask`` within 1e-6."""
    def loader(path):
        return np.full((32, 64, 3), float(len(path) % 255), np.float32)

    kw = dict(queue_length=2, final_dim=(32, 64), image_loader=loader, seed=7)
    if augment:
        kw.update(rot_range=(-0.3925, 0.3925), scale_ratio_range=(0.95, 1.05))
    ours = PerceptionTrainDataset(infos=two_scene_infos(make_synthetic_infos), **kw)
    ref = JTrainDataset(infos=two_scene_infos(jax_infos), **kw)
    checked = 0
    for i in range(len(ours.infos)):
        got = ours.window_with_gt(i, max_gt=8, pred_steps=12)
        want = ref.window_with_gt(i, max_gt=8, pred_steps=12)
        assert (got is None) == (want is None)
        if got is None:
            continue
        checked += 1
        assert len(got) == len(want) == 7
        for k in want[0]:
            np.testing.assert_allclose(got[0][k], want[0][k], rtol=0, atol=1e-6, err_msg=k)
        for a, b in zip(got[1:3] + got[5:], want[1:3] + want[5:]):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
        assert got[5].shape == got[6].shape == (1, 8, 12, 2)
    assert checked >= 10
    assert ours.rng.randint(1 << 30) == ref.rng.randint(1 << 30)


# ------------------------------------------------------------------- loss


def motion_batch(rng, b, gmax, counts):
    """Boxes and labels (``gt_batch``), and futures of ragged length: row
    i's valid steps are the first ``lengths[i]``, some 0."""
    boxes, labels = gt_batch(rng, b, gmax, counts)
    trajs = rng.normal(0, 8, (b, gmax, 12, 2)).astype(np.float32)
    mask = np.zeros((b, gmax, 12, 2), np.float32)
    for bi, g in enumerate(counts):
        for gi, n in enumerate(rng.integers(0, 13, g)):
            mask[bi, gi, :n] = 1.0
    mask[0, 0] = 0.0          # an empty future
    return boxes, labels, trajs * mask, mask


@pytest.fixture(scope="module")
def motion_outputs():
    """The tiny r50 + PETRMotionHead detector with the ATSS head, its
    ``train_window`` over 2 frames and its ``train_frame`` from a fresh
    memory, both with a DNPack (the JAX draws injected)."""
    with_threads = torch.get_num_threads()
    torch.set_num_threads(2)
    rng = np.random.default_rng(21)
    b, t, n, h, w = 2, 2, 6, 32, 64
    model = detector.StreamPETRWindow(**TINY_HEAD, backbone_cfg={"stage_blocks": BLOCKS},
                                      with_atss=True, atss_stacked_convs=1, head_type="motion")
    model.init_weights(torch.Generator().manual_seed(22), zero_init_std=0.02)
    imgs = T(rng.standard_normal((b, t, n, h, w, 3)).astype(np.float32))
    data = torch_tree(frame_data(rng, b, t, n, h, w))
    boxes, labels, trajs, mask = motion_batch(rng, b, 4, [4, 3])
    key = jax.random.PRNGKey(23)
    jpack = jdenoise.prepare_dn(key, jnp.asarray(boxes), jnp.asarray(labels), num_query=12,
                                num_propagated=8, memory_len=24, pc_range=PC)
    pack = denoise.prepare_dn(T(boxes), T(labels), num_query=12, num_propagated=8,
                              memory_len=24, pc_range=PC, rand_prob=T(dn_noise(key, b, 40)))
    with torch.no_grad():
        outs = {"window": model.train_window(imgs, data, dn=pack),
                "streaming": model.train_frame(imgs[:, 0], init_memory(b, 24, 32),
                                               {k: v[:, 0] for k, v in data.items()}, dn=pack)}
    torch.set_num_threads(with_threads)
    boxes2d, labels2d = [], []
    for _ in range(b * n):
        g = int(rng.integers(0, 4))
        xy = rng.uniform(0, 60, (g, 2))
        boxes2d.append(np.concatenate([xy, xy + rng.uniform(6, 30, (g, 2))], 1).astype(np.float32))
        labels2d.append(rng.integers(0, 10, g))
    return dict(outs=outs, pack=pack, jpack=jpack, boxes=boxes, labels=labels, trajs=trajs,
                mask=mask, boxes2d=boxes2d, labels2d=labels2d,
                anchors=atss.grid_anchors(atss.fpn_shapes((h, w), 5)))


@pytest.mark.parametrize("recipe", ["window", "streaming"])
def test_motion_loss_matches_the_jax_loss_functions(motion_outputs, recipe):
    """The port's loss on the tiny motion detector's outputs (``train_window``
    or ``train_frame``) against the JAX ``loss_fn``'s terms composed from
    the JAX package's public functions on the same outputs and the same
    (JAX) assignment: the Hungarian targets equal, and every term,
    ``loss_traj`` included, within 1e-5 of its value."""
    mo = motion_outputs
    outs, atss_outs, _ = mo["outs"][recipe]
    anchors = mo["anchors"]
    trainer = train.DetectorTrainer(PC, anchors_per_level=anchors, streaming=recipe == "streaming")
    with torch.no_grad():
        total, got, assignment = trainer.loss(
            outs, atss_outs, mo["pack"], T(mo["boxes"]), T(mo["labels"]),
            train.atss_targets(anchors, mo["boxes2d"], mo["labels2d"]),
            gt_trajs=T(mo["trajs"]), gt_traj_mask=T(mo["mask"]))
    j = {k: jnp.asarray(v.numpy()) for k, v in outs.items()}
    n_layers, b, q = j["all_cls_scores"].shape[:3]
    lb, g = n_layers * b, mo["labels"].shape[1]
    gnorm = np.asarray(jnorm(jnp.asarray(mo["boxes"])))
    lab_q, gn_q, mask_q, asg_q, _ = jtrain.make_batched_assigner(PC, 10, 2.0, 0.25)(
        np.asarray(j["all_cls_scores"]).reshape(lb, q, -1),
        np.asarray(j["all_bbox_preds"]).reshape(lb, q, -1),
        np.broadcast_to(gnorm[None], (n_layers,) + gnorm.shape).reshape(lb, g, -1),
        np.broadcast_to(mo["labels"][None], (n_layers, b, g)).reshape(lb, g))
    np.testing.assert_array_equal(assignment.labels.reshape(lb, q), lab_q)
    np.testing.assert_array_equal(assignment.mask.reshape(lb, q), mask_q)
    np.testing.assert_array_equal(assignment.assigned.reshape(lb, q), asg_q)
    assert mask_q.sum() > 0
    jtgt = jtrain.atss_targets(anchors, mo["boxes2d"], mo["labels2d"])

    @jax.jit
    def jax_loss(j, jatss_outs):
        # JAX loss_fn (:320-419) on given outputs and assignment
        n_pos = np.maximum(mask_q.reshape(n_layers, b, q).sum((1, 2)), 1.0)
        lq, gq, mq = (x.reshape((n_layers, b, q) + x.shape[2:]) for x in (lab_q, gn_q, mask_q))
        cls_l = jlosses.sigmoid_focal_loss(j["all_cls_scores"], jnp.asarray(lq), 10).sum((1, 2))
        diff = jnp.abs(j["all_bbox_preds"] - gq) * jnp.asarray(jlosses.CODE_WEIGHTS)
        diff = jnp.where(jnp.isfinite(diff), diff, 0.0)
        out = {"loss_cls": 2.0 * (cls_l / n_pos).sum(),
               "loss_bbox": 0.25 * ((diff.sum(-1) * mq).sum((1, 2)) / n_pos).sum()}
        traj_all, score_all = j["all_traj_preds"], j["all_traj_scores"]
        m, s = traj_all.shape[3], traj_all.shape[4]
        tgt_m, wts_m = jax.vmap(lambda pm, ag, gt, gm: jmotion.traj_targets_from_assignment(
            (q, m, s, 2), pm, ag, gt, gm))(
            jnp.asarray(mask_q) > 0, jnp.asarray(asg_q),
            jnp.broadcast_to(jnp.asarray(mo["trajs"])[None], (n_layers,) + mo["trajs"].shape
                             ).reshape((lb,) + mo["trajs"].shape[1:]),
            jnp.broadcast_to(jnp.asarray(mo["mask"])[None], (n_layers,) + mo["mask"].shape
                             ).reshape((lb,) + mo["mask"].shape[1:]))
        out["loss_traj"] = jmotion.traj_loss_v1(
            score_all.reshape(lb, q, m), traj_all.reshape(lb, q, m, s, 2),
            tgt_m.reshape(lb * q, m, s, 2), wts_m.reshape(lb * q, m, s, 2),
            avg_factor=n_pos.mean())
        out["loss_dn"] = jdenoise.dn_loss(j["dn_cls_scores"], j["dn_bbox_preds"], mo["jpack"], PC)
        out.update(jtrain.atss_loss(jatss_outs, anchors, jtgt))
        out["loss"] = sum(out.values())
        return out

    want = jax_loss(j, [tuple(jnp.asarray(x.permute(0, 2, 3, 1).numpy()) for x in lvl)
                        for lvl in atss_outs])
    assert got.keys() == want.keys() == JAX_LOSS_KEYS | {"loss_traj"}
    assert float(want["loss_traj"]) > 0
    for k in want:
        close(got[k].numpy(), want[k], 1e-5)
    assert float(total) == float(got["loss"])
    # without the futures the term is absent, as in JAX
    with torch.no_grad():
        _, bare, _ = trainer.loss(outs, atss_outs, mo["pack"], T(mo["boxes"]), T(mo["labels"]),
                                  assignment=assignment)
    assert "loss_traj" not in bare


# -------------------------------------------------------------- gradients


def test_dense_cross_attention_gradient_on_the_flash_route_matches_jax_grad(monkeypatch):
    """``PETRCrossAttention`` at the production head width (256, 8 heads of
    dim 32) from 132 queries to 300 tokens: the router takes
    ``flash_attention`` forward and backward (their plain versions on the
    CPU). The loss and the gradients of the query, the tokens, both
    position embeddings and every projection against ``jax.grad`` of the
    JAX cross-attention, within 1e-5 of each gradient's largest value."""
    rng = np.random.default_rng(31)
    b, sq, skv, c = 2, 132, 300, 256
    query, qpos = (rng.standard_normal((b, sq, c)).astype(np.float32) for _ in range(2))
    tokens, kpos = (rng.standard_normal((b, skv, c)).astype(np.float32) for _ in range(2))
    weight = rng.standard_normal((b, sq, c)).astype(np.float32)
    jmod = JPETRCrossAttention(embed_dims=c, num_heads=8)
    params = init_random(jmod, 32, *(jnp.asarray(x) for x in (query, tokens, qpos, kpos)))

    def jloss(prm, qu, ke, qp, kp):
        return (jmod.apply({"params": prm}, qu, ke, qp, kp) * weight).sum()

    jl, jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3, 4))(
        params, *(jnp.asarray(x) for x in (query, tokens, qpos, kpos)))
    flat = flatten({"m": params})
    sd = _packed_qkv(flat, ("m",), "attn")
    sd.update(apply_map(flat, _dense("attn.out_proj", ("m", "out_proj"))))
    mod = PETRCrossAttention(c, 8)
    mod.load_state_dict(sd, strict=True)

    calls, bwd = [], port_flash.flash_attention_bwd

    def counted_bwd(q, k, *a, **kw):
        calls.append((q.shape[1], k.shape[1], q.shape[3]))
        return bwd(q, k, *a, **kw)

    monkeypatch.setattr(port_flash, "flash_attention_bwd", counted_bwd)
    inputs = [T(x).requires_grad_() for x in (query, tokens, qpos, kpos)]
    loss = (mod(*inputs) * T(weight)).sum()
    loss.backward()
    assert calls == [(sq, skv, 32)]
    close(loss.detach().numpy(), jl, 1e-5)
    for got, want in zip(inputs, jgrads[1:]):
        close(got.grad.numpy(), want, 1e-5)
    jflat = flatten({"m": jax.tree.map(np.asarray, jgrads[0])})
    want = _packed_qkv(jflat, ("m",), "attn")
    want.update(apply_map(jflat, _dense("attn.out_proj", ("m", "out_proj"))))
    for name, prm in mod.named_parameters():
        close(prm.grad.numpy(), want[name].numpy(), 1e-5)


def test_traj_loss_v1_gradient_matches_jax_grad():
    """``traj_loss_v1`` on 2 x 7 queries of 6 modes and 12 steps (futures
    of ragged length, one empty): the loss and the gradients of the mode
    scores and the trajectories against ``jax.grad`` within 1e-5 of their
    largest value."""
    rng = np.random.default_rng(41)
    b, q, m, s = 2, 7, 6, 12
    prob = rng.standard_normal((b, q, m)).astype(np.float32)
    preds = rng.normal(0, 5, (b, q, m, s, 2)).astype(np.float32)
    steps = rng.integers(0, s + 1, b * q)
    steps[0] = 0
    mask = np.zeros((b * q, m, s, 2), np.float32)
    for i, n in enumerate(steps):
        mask[i, :, :n] = 1.0
    gt = rng.normal(0, 5, (b * q, m, s, 2)).astype(np.float32) * mask
    jl, (jg_prob, jg_preds) = jax.jit(jax.value_and_grad(
        lambda p, t: jmotion.traj_loss_v1(p, t, jnp.asarray(gt), jnp.asarray(mask), 5.0),
        argnums=(0, 1)))(jnp.asarray(prob), jnp.asarray(preds))
    tp, tt = T(prob).requires_grad_(), T(preds).requires_grad_()
    loss = motion_head.traj_loss_v1(tp, tt, T(gt), T(mask), 5.0)
    loss.backward()
    close(loss.detach().numpy(), jl, 1e-5)
    close(tp.grad.numpy(), jg_prob, 1e-5)
    close(tt.grad.numpy(), jg_preds, 1e-5)


# ------------------------------------------------------------ frozen set


@pytest.mark.parametrize("frozen_stages, bn_trainable", [(-1, True), (0, True), (1, True),
                                                         (1, False)])
def test_vovnet_frozen_set_matches_the_jax_mask(frozen_stages, bn_trainable):
    """The port's frozen VoVNet parameters (``DetectorOptimizer`` over
    ``img_backbone.*`` of a VoVNet at the tiny widths) against the JAX
    optimizer's mask: the parameters carried to the JAX tree through
    ``convert.vovnet_map``, one update of gradients of ones, and the set
    whose update is exactly zero (the batch-norm statistics, buffers in
    the port, left out), mapped back to the port's names: equal."""
    vov = VoVNet(**TINY_VOV)
    mapping = convert.vovnet_map("img_backbone", ("backbone",), TINY_VOV["num_blocks"],
                                 TINY_VOV["num_layers"])
    tree = to_jax(vov, mapping, prefix="img_backbone.")
    opt_kw = dict(backbone_frozen_stages=frozen_stages, backbone_bn_trainable=bn_trainable)
    jopt = jtrain.make_detector_optimizer(**opt_kw)
    updates, _ = jax.jit(jopt.update)(jax.tree.map(jnp.ones_like, tree), jopt.init(tree), tree)
    flat = flatten(jax.tree.map(np.asarray, updates))
    want = {ref for ref, (path, _) in mapping.items()
            if path[-1] not in ("mean", "var") and not np.any(flat[path])}
    named = {f"img_backbone.{k}": p for k, p in vov.named_parameters()}
    assert set(named) == {ref for ref, (path, _) in mapping.items()
                          if path[-1] not in ("mean", "var")}
    opt = train.DetectorOptimizer(named, **opt_kw)
    assert set(opt.frozen) == want
    stem = {k for k in named if k.startswith("img_backbone.stem.")}
    assert (stem <= want) == (frozen_stages >= 0)
    assert any(k.startswith("img_backbone.stage2.") for k in want) == (frozen_stages >= 1
                                                                       or not bn_trainable)
    assert not any(k.startswith("img_backbone.stage3.") and "/norm" not in k for k in want)


def test_vovnet_use_checkpoint_gives_the_same_loss_and_gradients():
    """VoVNet with ``use_checkpoint`` (the reference's with_cp: each OSA
    block recomputed in the backward) against the same weights without it,
    in training mode: the stage outputs and every parameter's gradient
    equal within 1e-6 of their largest value."""
    x = T(np.random.default_rng(72).standard_normal((2, 3, 32, 64)).astype(np.float32))
    plain = drawn(VoVNet(**TINY_VOV), 71).train()
    cp = VoVNet(**TINY_VOV, use_checkpoint=True).train()
    cp.load_state_dict(plain.state_dict())
    grads = []
    for net in (plain, cp):
        outs = net(x)
        sum((o * o).mean() for o in outs).backward()
        grads.append({k: p.grad for k, p in net.named_parameters()})
    for a, b in zip(plain(x), cp(x)):
        close(b.detach().numpy(), a.detach().numpy(), 1e-6)
    assert grads[0].keys() == grads[1].keys()
    for k in grads[0]:
        close(grads[1][k].numpy(), grads[0][k].numpy(), 1e-6)
    assert cp.stage2[0].layers[0][0].weight.grad is not None


# -------------------------------------------------------------- PETRHeadDN


def test_petr_head_dn_with_dn_queries_matches_jax_on_the_reference_mask():
    """PETRHeadDN self-attends over its current queries alone, so the
    reference builds its DN mask over pad + num_query (petr_head_dn.py
    prepare_for_dn). The JAX package's ``prepare_dn`` sized by the
    detector's propagated queries and memory gives a mask the JAX head
    cannot add (a JAX fault; ROADMAP Queue C); the port's trainer builds
    the reference's square mask for this head, equal to JAX
    ``build_dn_attn_mask`` without memory. Handed that mask, the tiny head
    with DN queries (batch 2, 3 cameras) matches the JAX head: the DN and
    the match slices within 1e-5 of their largest value."""
    rng = np.random.default_rng(51)
    b, n, h, w, c = 2, 3, 32, 64, 32
    cfg = dict(TINY, num_levels=1, num_cams=n, depth_num=32)
    data, feats = head_inputs(rng, b, n, h, w, c, 1, levels=(4,))
    d0 = {k: v[:, 0] for k, v in data.items()}
    boxes, labels = gt_batch(rng, b, 3, [3, 1])
    key = jax.random.PRNGKey(52)
    head = drawn(PETRHeadDN(**cfg), 53)
    params, _ = convert_streampetr_checkpoint(
        {f"pts_bbox_head.{k}": v.numpy() for k, v in head.state_dict().items()}, num_layers=2,
        stage_blocks=BLOCKS, head="petr_dn")
    jhead = JPETRHeadDN(**cfg)
    jfeats = [jnp.asarray(f) for f in feats[0]]
    jd0 = {k: jnp.asarray(v) for k, v in d0.items()}

    def jrun(pack):    # compiled whole, the pack's pad_size static
        return jax.jit(lambda arrays: jhead.apply(
            {"params": params["head"]}, jfeats, jinit_memory(b, 24, c), jd0, (h, w),
            dn=jdenoise.DNPack(*arrays, pack.pad_size))[0])(tuple(pack[:-1]))

    streaming_pack = jdenoise.prepare_dn(key, jnp.asarray(boxes), jnp.asarray(labels),
                                         num_query=12, num_propagated=8, memory_len=24,
                                         pc_range=PC)
    with pytest.raises(TypeError, match="broadcast"):
        jrun(streaming_pack)
    jpack = jdenoise.prepare_dn(key, jnp.asarray(boxes), jnp.asarray(labels), num_query=12,
                                num_propagated=0, memory_len=0, pc_range=PC)
    pad = jpack.pad_size
    model = detector.StreamPETRWindow(**dict(TINY_HEAD, num_cams=n), head_type="petr_dn",
                                      backbone_cfg={"stage_blocks": BLOCKS})
    model.init_weights(torch.Generator().manual_seed(54), zero_init_std=0.02)
    trainer = train.DetectorTrainer(PC, streaming=True)
    imgs = T(rng.standard_normal((b, 1, n, h, w, 3)).astype(np.float32))
    draws = train.StepDraws(None, T(dn_noise(key, b, pad)))
    with torch.no_grad():
        outs, _, _, pack = trainer.forward(model, imgs[:, 0], torch_tree(d0), T(boxes),
                                           T(labels), draws, init_memory(b, 24, 32))
    assert pack.attn_mask.shape == (pad + 12, pad + 12) == jpack.attn_mask.shape
    np.testing.assert_array_equal(pack.attn_mask.numpy(), np.asarray(jpack.attn_mask))
    np.testing.assert_array_equal(pack.attn_mask.numpy(),
                                  jdenoise.build_dn_attn_mask(pad, 12, 0, 0, 10))
    assert outs["dn_cls_scores"].shape == (2, b, pad, 10)
    jouts = jrun(jpack)
    with torch.no_grad():
        got, _ = head(port_feats(feats[0]), init_memory(b, 24, c), torch_tree(d0), (h, w),
                      dn=pack)
    assert got.keys() == jouts.keys() and got["dn_bbox_preds"].shape == (2, b, pad, 10)
    for k in jouts:
        close(got[k].numpy(), jouts[k], 1e-5)


# -------------------------------------------------------------------- CLI


def run(tmp_path, *flags):
    return train_cli.main(["--synthetic", "--tiny", "--device", "cpu", "--workdir",
                           str(tmp_path), "--queue_length", "2", "--final_dim", "32", "64"]
                          + list(flags))


def recipe(tmp_path, base, name, **params):
    """``base`` with ``perception.detector.params`` overridden, written as
    ``name``.yaml (the training CLI's ``--config``)."""
    cfg = copy.deepcopy(PERCEPTION[base])
    cfg["perception"]["detector"]["params"].update(params)
    path = tmp_path / f"{name}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


R50_PETR = dict(head_type="petr", backbone_cfg={"stage_blocks": list(BLOCKS)})
VOV = dict(backbone_type="vovnet", neck_start_level=2,
           backbone_cfg={k: list(v) if isinstance(v, tuple) else v for k, v in TINY_VOV.items()})
VOV_PETR_DN = dict(VOV, head_type="petr_dn",
                   backbone_cfg=dict(VOV["backbone_cfg"], use_checkpoint=True))
MOTION = dict(head_type="motion", backbone_cfg={"stage_blocks": list(BLOCKS)})


@pytest.mark.parametrize("base, params, traj", [
    (WINDOW, R50_PETR, False), (WINDOW, VOV_PETR_DN, False), (STREAMING, MOTION, True)],
    ids=["window_r50_petr", "window_vovnet_petr_dn", "streaming_motion"])
def test_cli_trains_the_dense_family(tmp_path, base, params, traj):
    """Two steps of the training CLI from a written YAML: the JAX CLI's
    train log (with ``loss_traj`` for the motion head), every term finite,
    a checkpoint, the backbone's stem frozen and, with the motion head, the
    trajectory branch trained."""
    config = recipe(tmp_path, base, "zoo", **params)
    log = run(tmp_path, "--config", config, "--steps", "2", "--ckpt_every", "2")
    with open(tmp_path / "zoo" / "train_log.json") as f:
        written = json.load(f)
    assert written.keys() == {"steps", "final_metrics"} and written["steps"] == 2
    keys = JAX_LOSS_KEYS | ({"loss_traj"} if traj else set())
    assert written["final_metrics"].keys() == keys
    assert all(math.isfinite(v) for v in written["final_metrics"].values())
    assert sorted(os.listdir(tmp_path / "zoo")) == ["final.pt", "iter_2", "train_log.json"]
    state = log["state"]
    assert state.model.head_type == params["head_type"]
    frozen = state.optimizer.frozen
    stem = "img_backbone.stem." if params.get("backbone_type") == "vovnet" else "img_backbone.conv1"
    assert any(k.startswith(stem) for k in frozen)
    if traj:
        assert log["final_metrics"]["loss_traj"] > 0
        assert any(k.startswith("pts_bbox_head.traj_branches.") for k in state.params)


def test_cli_motion_streaming_resumes_bit_exactly(tmp_path):
    """The streaming motion recipe, three steps in one run against two, a
    checkpoint and a resumed step: the train log and every tensor of
    final.pt equal."""
    config = recipe(tmp_path, STREAMING, "motion", **MOTION)
    base = ["--config", config, "--ckpt_every", "2"]
    whole = run(tmp_path / "whole", "--steps", "3", *base)
    run(tmp_path / "cut", "--steps", "2", *base)
    resumed = run(tmp_path / "cut", "--steps", "3", "--resume", str(tmp_path / "cut" / "motion"),
                  *base)
    assert whole["steps"] == resumed["steps"] == resumed["state"].step == 3
    assert whole["final_metrics"] == resumed["final_metrics"]
    assert "loss_traj" in whole["final_metrics"]
    a, b = (torch.load(p / "motion" / "final.pt") for p in (tmp_path / "whole", tmp_path / "cut"))
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_load_from_a_vovnet_petr_pth_freezes_the_vovnet_stem(tmp_path, capsys):
    """An mmdet-style ``.pth`` of VoVNet + StreamPETRHead + the ATSS head
    (its state dict inside 'state_dict', one name the detector lacks) loads
    by name and shape, the port's names being the mmdet names of
    ``convert``'s VoVNet and PETR maps: every tensor of the
    detector restored and counted as the JAX CLI counts; after a step the
    frozen stem and stage2 and every batch-norm statistic keep the loaded
    values, and stage3 moved."""
    params = dict(VOV, head_type="petr")
    src = detector.StreamPETRWindow(**train_cli.TINY, **params, with_atss=True)
    src.init_weights(torch.Generator().manual_seed(61), zero_init_std=0.02)
    sd = dict(src.state_dict())
    sd["img_backbone.stem.stem_1/norm.num_batches_tracked"] = torch.tensor(0)
    path = tmp_path / "vov_petr.pth"
    torch.save({"state_dict": sd}, path)
    config = recipe(tmp_path, WINDOW, "vov_petr", **params)
    log = run(tmp_path, "--config", config, "--steps", "1", "--load_from", str(path))
    assert log["load_from"] == {"path": str(path), "n_loaded": len(sd) - 1, "n_skipped": 1}
    assert f"merged {len(sd) - 1} pretrained tensors" in capsys.readouterr().out
    got = log["state"].model.state_dict()
    frozen = [k for k in got if k.startswith(("img_backbone.stem.", "img_backbone.stage2."))
              or k.endswith(("running_mean", "running_var"))]
    assert len(frozen) > 20
    assert all(torch.equal(got[k], sd[k]) for k in frozen)
    moved = "img_backbone.stage3.OSA3_1.layers.0.OSA3_1_0/conv.weight"
    assert not torch.equal(got[moved], sd[moved])
