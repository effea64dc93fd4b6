"""The port's perception modules against the JAX package's, on the CPU.

Every parameter of the JAX module is drawn from a seed (weights normal with
std 1/sqrt(fan_in), everything else, zero-initialised layers and biases
included, random too; batch-norm variances in [0.5, 1.5]) and carried into
the port by ``streampetr_state_dict_from_jax``. The inputs are numpy arrays
from a seed. Tolerances are stated per test: fp32 on both sides, in
another order of summation.
"""

import math

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panacea_tpu.perception import coder as jcoder
from panacea_tpu.perception import detector as jdetector
from panacea_tpu.perception import metrics as jmetrics
from panacea_tpu.perception.deformable import DeformableFeatureAggregation as JDeformable
from panacea_tpu.perception.fpn import FPN as JFPN
from panacea_tpu.perception.head import SparseHead as JSparseHead
from panacea_tpu.perception.head import init_memory as jinit_memory
from panacea_tpu.perception.resnet import ResNet50 as JResNet50
from panacea_tpu.utils.convert import convert_streampetr_checkpoint
from panacea_tpu_torch.convert import (
    apply_map,
    flatten,
    sparse_head_map,
    streampetr_state_dict_from_jax,
)
from panacea_tpu_torch.ops import attention as port_attention
from panacea_tpu_torch.perception import coder, detector, metrics
from panacea_tpu_torch.perception.deformable import DeformableFeatureAggregation, project_points
from panacea_tpu_torch.perception.fpn import FPN
from panacea_tpu_torch.perception.head import SparseHead, init_memory, topk_stable
from panacea_tpu_torch.perception.resnet import ResNet50

TINY = dict(embed_dims=32, num_query=12, memory_len=24, topk_proposals=8, num_propagated=8,
            num_decoder_layers=2, num_cams=6)
BLOCKS = (1, 1, 1, 1)


def randomize(shapes, seed):
    """A parameter tree of the same structure with every leaf drawn."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, leaf in flax.traverse_util.flatten_dict(shapes).items():
        name = path[-1]
        if name == "kernel":
            x = rng.standard_normal(leaf.shape) / math.sqrt(np.prod(leaf.shape[:-1]))
        elif name in ("var", "scale"):
            x = rng.uniform(0.5, 1.5, leaf.shape)
        elif name in ("reference_points", "pseudo_reference_points"):
            x = rng.uniform(0.0, 1.0, leaf.shape)
        else:
            x = rng.normal(0.0, 0.1, leaf.shape)
        out[path] = x.astype(np.float32)
    return flax.traverse_util.unflatten_dict(out)


def init_random(module, seed, *args, method=None):
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, method=method))
    return randomize(shapes["params"], seed)


def sub_state(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def close(got, want, rel):
    """|got - want| <= rel * max|want|, elementwise."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def calib(rng, b, n, h, w):
    """lidar2img of n cameras around the ego (pinhole, fx = fy = 100), each
    looking along its own heading, and the matching intrinsics and
    extrinsics, (B, N, 4, 4)."""
    l2i, intr, extr = (np.zeros((b, n, 4, 4), np.float32) for _ in range(3))
    for ci in range(n):
        yaw = 2 * np.pi * ci / n + rng.uniform(-0.1, 0.1)
        c, s = np.cos(yaw), np.sin(yaw)
        # lidar (x fwd, y left, z up) -> camera (x right, y down, z fwd)
        rot = np.array([[s, -c, 0], [0, 0, -1], [c, s, 0]])
        e = np.eye(4)
        e[:3, :3], e[:3, 3] = rot, rng.uniform(-1, 1, 3)
        k = np.eye(4)
        k[0, 0] = k[1, 1] = 100.0
        k[0, 2], k[1, 2] = w / 2, h / 2
        l2i[:, ci], intr[:, ci], extr[:, ci] = k @ e, k, e
    return l2i, intr, extr


def frame_data(rng, b, t, n, h, w):
    """data_seq of a window: the first frame starts a scene; the ego turns
    and moves between frames."""
    l2i, intr, extr = calib(rng, b, n, h, w)
    ego = np.zeros((b, t, 4, 4), np.float32)
    for fi in range(t):
        yaw = 0.05 * fi
        ego[:, fi] = np.eye(4)
        ego[:, fi, :2, :2] = [[np.cos(yaw), -np.sin(yaw)], [np.sin(yaw), np.cos(yaw)]]
        ego[:, fi, :3, 3] = [2.0 * fi, 0.3 * fi, 0.0]
    return {"prev_exists": np.array([[0.0] + [1.0] * (t - 1)] * b, np.float32),
            "timestamp": np.tile(np.arange(t, dtype=np.float32) * 0.5, (b, 1)),
            "ego_pose": ego, "ego_pose_inv": np.linalg.inv(ego).astype(np.float32),
            "lidar2img": np.repeat(l2i[:, None], t, 1), "intrinsics": np.repeat(intr[:, None], t, 1),
            "extrinsics": np.repeat(extr[:, None], t, 1)}


def torch_tree(x):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in x.items()}


def test_resnet_fpn_levels_match_jax():
    """ResNet-50 (one block a stage) and the 5-level FPN on a 64 x 128 image:
    every level within 1e-5 of its largest value."""
    x = np.random.default_rng(1).standard_normal((2, 64, 128, 3)).astype(np.float32)
    jres, jfpn = JResNet50(stage_blocks=BLOCKS), JFPN(out_channels=64, num_outs=5)
    bparams = init_random(jres, 2, jnp.asarray(x))
    stages = jres.apply({"params": bparams}, jnp.asarray(x))
    nparams = init_random(jfpn, 3, stages)
    want = jfpn.apply({"params": nparams}, stages)

    sd = streampetr_state_dict_from_jax({"backbone": bparams, "neck": nparams}, num_layers=0,
                                        stage_blocks=BLOCKS)
    res, fpn = ResNet50(stage_blocks=BLOCKS), FPN(out_channels=64, num_outs=5)
    res.load_state_dict(sub_state(sd, "img_backbone."), strict=True)
    fpn.load_state_dict(sub_state(sd, "img_neck."), strict=True)
    with torch.no_grad():
        got = fpn(res(torch.from_numpy(x).permute(0, 3, 1, 2)))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        close(g.permute(0, 2, 3, 1).numpy(), w, 1e-5)


def test_deformable_aggregation_matches_jax_off_image_and_behind_the_camera():
    """Key points that land off every image and behind cameras (depth
    clipped at 1e-5), joint softmax over cameras x levels x points: within
    1e-5 of the output's largest value."""
    rng = np.random.default_rng(4)
    b, q, c, n, h, w = 1, 40, 32, 2, 64, 128
    inst = rng.standard_normal((b, q, c)).astype(np.float32)
    qpos = rng.standard_normal((b, q, c)).astype(np.float32)
    feats = [rng.standard_normal((b, n, h // s, w // s, c)).astype(np.float32) for s in (8, 16)]
    ref = rng.uniform([-30, -30, -3], [30, 30, 3], (b, q, 3)).astype(np.float32)
    l2i, _, _ = calib(rng, b, n, h, w)
    jmod = JDeformable(embed_dims=c, num_levels=2, num_cams=n, num_pts=5)
    args = (jnp.asarray(inst), jnp.asarray(qpos), [jnp.asarray(f) for f in feats],
            jnp.asarray(ref), jnp.asarray(l2i), (h, w))
    params = init_random(jmod, 5, *args)
    want = jmod.apply({"params": params}, *args)

    sd = apply_map(flatten({"head": {"cross_attn_0": params}}), sparse_head_map("h", ("head",), 1))
    sd = sub_state(sd, "h.transformer.decoder.layers.0.attentions.1.")
    mod = DeformableFeatureAggregation(embed_dims=c, num_levels=2, num_cams=n, num_pts=5)
    mod.load_state_dict(sd, strict=True)
    t = torch.from_numpy
    with torch.no_grad():
        got = mod(t(inst), t(qpos), [t(f).flatten(0, 1).permute(0, 3, 1, 2) for f in feats],
                  t(ref), t(l2i), (h, w))
        # the key points really are off the images and behind the cameras
        kp = t(ref)[:, :, None] + mod.learnable_fc(t(inst)).reshape(b, q, 5, 3)
        depth = torch.einsum("bnj,bqpj->bnqp", t(l2i)[:, :, 2],
                             torch.cat([kp, torch.ones_like(kp[..., :1])], -1))
        uv = project_points(kp, t(l2i), (h, w))
    inside = ((uv >= 0) & (uv <= 1)).all(-1) & (depth > 0)
    for kind in (depth <= 0, (~inside) & (depth > 0), inside):   # behind, off the image, on it
        assert kind.float().mean() > 0.05
    close(got.numpy(), want, 1e-5)


def test_sparse_head_two_frames_on_the_flash_route_matches_jax(monkeypatch):
    """The production head width (embed 256, 8 heads of dim 32) with 100
    queries, 32 propagated and a 200-slot memory, 2 layers, over 2 frames:
    the memory carries over and the self-attention has Sq 132 and Skv 300,
    which the router sends to ``flash_attention`` (its plain version on
    the CPU). Scores, boxes and the memory within 1e-4 of their largest
    value."""
    rng = np.random.default_rng(6)
    b, n, h, w, c = 1, 2, 64, 128, 256
    cfg = dict(embed_dims=c, num_query=100, memory_len=200, topk_proposals=32,
               num_propagated=32, num_decoder_layers=2, num_levels=2, num_cams=n)
    data = frame_data(rng, b, 2, n, h, w)
    feats = [[rng.standard_normal((b, n, h // s, w // s, c)).astype(np.float32)
              for s in (8, 16)] for _ in range(2)]
    jhead = JSparseHead(**cfg)
    d0 = {k: jnp.asarray(v[:, 0]) for k, v in data.items()}
    params = init_random(jhead, 7, [jnp.asarray(f) for f in feats[0]], jinit_memory(b, 200, c),
                         d0, (h, w))
    run = jax.jit(lambda p, f, m, d: jhead.apply({"params": p}, f, m, d, (h, w)))
    jmem = jinit_memory(b, 200, c)
    for fi in range(2):
        jouts, jmem = run(params, [jnp.asarray(f) for f in feats[fi]], jmem,
                          {k: jnp.asarray(v[:, fi]) for k, v in data.items()})

    calls = []
    flash = port_attention.flash_attention

    def counted(q, k, v, **kw):
        calls.append((q.shape[1], k.shape[1], q.shape[3]))
        return flash(q, k, v, **kw)

    monkeypatch.setattr(port_attention, "flash_attention", counted)
    sd = streampetr_state_dict_from_jax({"head": params}, num_layers=2)
    head = SparseHead(**cfg)
    head.load_state_dict(sub_state(sd, "pts_bbox_head."), strict=True)
    mem = init_memory(b, 200, c)
    with torch.no_grad():
        for fi in range(2):
            outs, mem = head([torch.from_numpy(f).flatten(0, 1).permute(0, 3, 1, 2)
                              for f in feats[fi]], mem,
                             {k: torch.from_numpy(v[:, fi]) for k, v in data.items()}, (h, w))
    assert calls == [(132, 300, 32)] * 4
    for key in ("all_cls_scores", "all_bbox_preds"):
        close(outs[key].numpy(), jouts[key], 1e-4)
    for field in jmem._fields:
        close(getattr(mem, field).numpy(), getattr(jmem, field), 1e-4)


def test_tiny_detector_window_through_decode_matches_jax():
    """The tiny detector (ResNet-50 with one block a stage, 6 cameras) over a
    2-frame window, then ``NMSFreeCoder.decode``: the same boxes in the same
    order, labels equal, scores and boxes within 1e-4 of their largest
    value."""
    rng = np.random.default_rng(8)
    b, t, n, h, w = 1, 2, 6, 64, 128
    imgs = rng.standard_normal((b, t, n, h, w, 3)).astype(np.float32)
    data = frame_data(rng, b, t, n, h, w)
    jmodel = jdetector.StreamPETRWindow(backbone_cfg={"stage_blocks": BLOCKS}, **TINY)
    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    params = init_random(jmodel, 9, jnp.asarray(imgs), jdata)
    jouts, _ = jax.jit(lambda p, i, d: jmodel.apply({"params": p}, i, d))(
        params, jnp.asarray(imgs), jdata)
    model = detector.StreamPETRWindow(backbone_cfg={"stage_blocks": BLOCKS}, **TINY)
    model.load_state_dict(streampetr_state_dict_from_jax(params, num_layers=2,
                                                         stage_blocks=BLOCKS), strict=True)
    with torch.no_grad():
        outs, _ = model(torch.from_numpy(imgs), torch_tree(data))
    pc = (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0)
    want = jcoder.NMSFreeCoder(pc_range=pc, max_num=20).decode(jouts)[0]
    got = coder.NMSFreeCoder(pc_range=pc, max_num=20).decode(outs)[0]
    assert len(want["labels"]) > 10
    np.testing.assert_array_equal(got["labels"], want["labels"])
    np.testing.assert_array_equal(got["box_idx"], want["box_idx"])
    close(got["scores"], want["scores"], 1e-4)
    close(got["bboxes"], want["bboxes"], 1e-4)


def test_top_k_ties_come_lowest_index_first_as_in_jax():
    """Saturated sigmoid scores tie at 1.0 in fp32; ``jax.lax.top_k`` and the
    port give the same indices, in the head's selection and in the
    decoder's."""
    rng = np.random.default_rng(10)
    x = rng.choice([1.0, 0.5, 0.25], size=(3, 64)).astype(np.float32)
    for k in (1, 8, 40, 64):
        _, want = jax.lax.top_k(jnp.asarray(x), k)
        _, got = topk_stable(torch.from_numpy(x), k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    logits = rng.standard_normal((30, 10)).astype(np.float32)
    logits[rng.random((30, 10)) < 0.3] = 40.0   # sigmoid(40) == 1.0 in fp32
    boxes = rng.standard_normal((30, 10)).astype(np.float32)
    pc = (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0)
    want = jcoder.NMSFreeCoder(pc_range=pc, max_num=50).decode_single(
        jnp.asarray(logits), jnp.asarray(boxes))
    got = coder.NMSFreeCoder(pc_range=pc, max_num=50).decode_single(
        torch.from_numpy(logits), torch.from_numpy(boxes))
    assert (want["scores"] == 1.0).sum() > 40
    for key in ("labels", "box_idx", "scores"):
        np.testing.assert_array_equal(got[key], want[key])


def test_metric_equals_jax_exactly():
    """The port's copy of the metric on the same predictions: every number
    equal, not close."""
    rng = np.random.default_rng(11)
    preds, gts = [], []
    for _ in range(6):
        ng, npred = rng.integers(3, 9), rng.integers(5, 30)
        gboxes = np.concatenate([rng.uniform(-40, 40, (ng, 2)), rng.uniform(-2, 0, (ng, 1)),
                                 rng.uniform(0.5, 5, (ng, 3)), rng.uniform(-3, 3, (ng, 3))], 1)
        glabels = rng.integers(0, 10, ng)
        near = gboxes[rng.integers(0, ng, npred)] + rng.normal(0, 0.8, (npred, 9))
        near[:, 3:6] = np.abs(near[:, 3:6]) + 0.1
        preds.append({"boxes": near, "labels": np.where(rng.random(npred) < 0.7,
                                                        glabels[rng.integers(0, ng, npred)],
                                                        rng.integers(0, 10, npred)),
                      "scores": rng.random(npred)})
        gts.append({"boxes": gboxes, "labels": glabels})
    want = jmetrics.evaluate_detections(preds, gts)
    assert want["mAP"] > 0
    assert metrics.evaluate_detections(preds, gts) == want
    assert metrics.CLASS_NAMES == jmetrics.CLASS_NAMES


def test_state_dict_round_trips_through_the_jax_converter():
    """The port detector's state dict, given to the JAX package's
    ``convert_streampetr_checkpoint``, gives back the tree it came from,
    leaf for leaf, with no key missing or unexpected."""
    jmodel = jdetector.StreamPETRWindow(backbone_cfg={"stage_blocks": BLOCKS}, **TINY)
    rng = np.random.default_rng(12)
    data = frame_data(rng, 1, 1, 6, 64, 128)
    params = init_random(jmodel, 13, jnp.zeros((1, 1, 6, 64, 128, 3)),
                         {k: jnp.asarray(v) for k, v in data.items()})
    model = detector.StreamPETRWindow(backbone_cfg={"stage_blocks": BLOCKS}, **TINY)
    model.load_state_dict(streampetr_state_dict_from_jax(params, num_layers=2,
                                                         stage_blocks=BLOCKS), strict=True)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    back, report = convert_streampetr_checkpoint(sd, num_layers=2, stage_blocks=BLOCKS)
    assert report == {"missing": [], "unexpected": []}
    want = flax.traverse_util.flatten_dict(params)
    got = flax.traverse_util.flatten_dict(back)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), want[k], err_msg=str(k))


def test_detector_refuses_what_is_not_ported():
    for kw in ({"backbone_type": "eva"}, {"head_type": "sparse_v3"}, {"head_type": "sparse_v4"}):
        with pytest.raises(NotImplementedError, match="Queue A item 6"):
            detector.StreamPETRWindow(**TINY, **kw)
