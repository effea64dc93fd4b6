"""The port's perception training modules against the JAX package's, on the
CPU.

Inputs are numpy arrays from seeds; the JAX parameter trees have every leaf
drawn (``test_torch_perception.init_random``, zero-initialised layers
included) and are carried into the port by ``streampetr_state_dict_from_jax``.
The JAX random draws (GridMask, the DN noise) are injected into the port.
Nothing here differentiates the JAX detector: its forwards are compared,
the loss is composed from the JAX package's public loss functions on the
same outputs, and the one gradient held against ``jax.grad`` is the
DN-masked self-attention's under a focal loss. Tolerances: exact for the
Hungarian indices, masks, anchors, assignments and dataset arrays; 1e-5 of
the largest value for losses, costs and single modules; 1e-4 for the tiny
head and detector (fp32 in another order of summation, through a ResNet).
"""

import copy
import math
import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml
from torch_parity import two_threads  # noqa: F401

from panacea_tpu.data.nuscenes.synthetic import make_synthetic_infos as jax_infos
from panacea_tpu.perception import atss as jatss
from panacea_tpu.perception.coder import normalize_bbox as jnorm
from panacea_tpu.perception import denoise as jdenoise
from panacea_tpu.perception import detector as jdetector
from panacea_tpu.perception import train as jtrain
from panacea_tpu.perception import train_losses as jlosses
from panacea_tpu.perception.eval_dataset import GenNuScenesEvalDataset as JEvalDataset
from panacea_tpu.perception.gridmask import grid_mask as jgrid_mask
from panacea_tpu.perception.head import MultiheadSelfAttention as JMHSA
from panacea_tpu.perception.head import SparseHead as JSparseHead
from panacea_tpu.perception.head import init_memory as jinit_memory
from panacea_tpu.perception.train_dataset import PerceptionTrainDataset as JTrainDataset
from panacea_tpu.perception.train_dataset import StreamingSampler as JStreamingSampler
from panacea_tpu.perception.train_dataset import sequence_group_flags as jflags
from panacea_tpu.utils.convert import convert_streampetr_checkpoint
from panacea_tpu_torch import configs
from panacea_tpu_torch.convert import (_dense, _packed_qkv, apply_map, flatten,
                                       streampetr_state_dict_from_jax)
from panacea_tpu_torch.data.nuscenes.synthetic import make_synthetic_infos
from panacea_tpu_torch.perception import atss, denoise, detector, train, train_losses
from panacea_tpu_torch.perception.eval_dataset import GenNuScenesEvalDataset
from panacea_tpu_torch.perception.gridmask import GridDraws, grid_mask
from panacea_tpu_torch.perception.head import MultiheadSelfAttention, SparseHead, init_memory
from panacea_tpu_torch.perception.train_dataset import (PerceptionTrainDataset, StreamingSampler,
                                                        sequence_group_flags)
from panacea_tpu_torch.registry import resolve_target
from test_torch_perception import BLOCKS, TINY, close, frame_data, init_random, sub_state

pytestmark = pytest.mark.usefixtures("two_threads")
ROOT = os.path.join(os.path.dirname(__file__), "..")
PC = (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0)
T = torch.from_numpy


def gt_batch(rng, b, gmax, counts):
    """gt_boxes (B, Gmax, 9) zero-padded inside the pc range, gt_labels
    (B, Gmax) -1-padded, ``counts[i]`` real boxes in row i."""
    boxes = np.zeros((b, gmax, 9), np.float32)
    labels = np.full((b, gmax), -1, np.int64)
    for i, g in enumerate(counts):
        boxes[i, :g, :2] = rng.uniform(-40, 40, (g, 2))
        boxes[i, :g, 2] = rng.uniform(-2, 0, g)
        boxes[i, :g, 3:6] = rng.uniform(0.5, 5, (g, 3))
        boxes[i, :g, 6] = rng.uniform(-3, 3, g)
        boxes[i, :g, 7:9] = rng.normal(0, 2, (g, 2))
        labels[i, :g] = rng.integers(0, 10, g)
    return boxes, labels


def dn_noise(key, b, pad):
    """The noise JAX prepare_dn draws from ``key``."""
    return np.asarray(jax.random.uniform(key, (b, pad, 3), minval=-1.0, maxval=1.0))


# ------------------------------------------------------------ losses, costs


def test_focal_loss_costs_and_single_sample_loss_match_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(0, 3, (40, 10)).astype(np.float32)
    labels = rng.integers(0, 11, 40)
    close(train_losses.sigmoid_focal_loss(T(logits), T(labels), 10).numpy(),
          jlosses.sigmoid_focal_loss(jnp.asarray(logits), jnp.asarray(labels), 10), 1e-5)
    gl = rng.integers(0, 10, 7)
    close(train_losses.focal_cls_cost(T(logits), T(gl)).numpy(),
          jlosses.focal_cls_cost(jnp.asarray(logits), jnp.asarray(gl)), 1e-5)
    boxes, _ = gt_batch(rng, 1, 7, [7])
    preds = rng.normal(0, 5, (40, 10)).astype(np.float32)
    gnorm = np.array(jnorm(jnp.asarray(boxes[0])))
    close(train_losses.bbox_l1_cost(T(preds), T(gnorm)).numpy(),
          jlosses.bbox_l1_cost(jnp.asarray(preds), jnp.asarray(gnorm)), 1e-5)
    got = train_losses.detection_loss_single(T(logits), T(preds), boxes[0], gl, PC)
    want = jlosses.detection_loss_single(jnp.asarray(logits), jnp.asarray(preds), boxes[0], gl, PC)
    for k in want:
        close(got[k].numpy(), want[k], 1e-5)
    empty = train_losses.detection_loss_single(T(logits), T(preds), boxes[0][:0], gl[:0], PC)
    jempty = jlosses.detection_loss_single(jnp.asarray(logits), jnp.asarray(preds),
                                           boxes[0][:0], gl[:0], PC)
    close(empty["loss_cls"].numpy(), jempty["loss_cls"], 1e-5)
    assert float(empty["loss_bbox"]) == float(jempty["loss_bbox"]) == 0.0


def test_batched_hungarian_assignment_equals_jax_exactly():
    """Every layer and sample matched on the host: the indices, labels and
    targets of the port's assigner equal the JAX one's, a sample with no gt
    and nan velocities included."""
    rng = np.random.default_rng(1)
    n, q, g = 6, 30, 9
    cls = rng.normal(0, 2, (n, q, 10)).astype(np.float32)
    bbox = rng.normal(0, 5, (n, q, 10)).astype(np.float32)
    gnorm = rng.normal(0, 3, (n, g, 10)).astype(np.float32)
    gnorm[1, 2, 8:] = np.nan
    labels = rng.integers(0, 10, (n, g))
    labels[0] = -1
    labels[2, 5:] = -1
    got = train.make_batched_assigner(PC, 10, 2.0, 0.25)(cls, bbox, gnorm, labels)
    want = jtrain.make_batched_assigner(PC, 10, 2.0, 0.25)(cls, bbox, gnorm, labels)
    assert want[2].sum() > 0 and want[2][0].sum() == 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------- ATSS


def atss_pair(seed, convs=2, levels=3, c=16):
    jhead = jatss.ATSSHead(num_classes=10, in_channels=c, feat_channels=c, stacked_convs=convs,
                           num_levels=levels)
    rng = np.random.default_rng(seed)
    shapes = atss.fpn_shapes((48, 80), levels)
    feats = [rng.standard_normal((2, h, w, c)).astype(np.float32) for h, w in shapes]
    params = init_random(jhead, seed, [jnp.asarray(f) for f in feats])
    sd = streampetr_state_dict_from_jax({"roi_head": params}, num_layers=0,
                                        atss_stacked_convs=convs)
    head = atss.ATSSHead(num_classes=10, in_channels=c, feat_channels=c, stacked_convs=convs,
                         num_levels=levels)
    head.load_state_dict(sub_state(sd, "img_roi_head."), strict=True)
    return jhead, params, head, feats, shapes


def test_atss_head_anchors_assignment_and_targets_match_jax():
    """The head's per-level outputs (scales drawn too) within 1e-5; the FPN
    shapes, anchors, assignment, centerness and targets exactly."""
    jhead, params, head, feats, shapes = atss_pair(2)
    want = jhead.apply({"params": params}, [jnp.asarray(f) for f in feats])
    with torch.no_grad():
        got = head([T(f).permute(0, 3, 1, 2) for f in feats])
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            close(a.permute(0, 2, 3, 1).numpy(), b, 1e-5)
    for hw, nl in (((256, 512), 5), ((64, 128), 5), ((16, 32), 3)):
        assert atss.fpn_shapes(hw, nl) == jatss.fpn_shapes(hw, nl)
    anchors = atss.grid_anchors(shapes)
    for a, b in zip(anchors, jatss.grid_anchors(shapes)):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(3)
    boxes2d, labels2d = [], []
    for i in range(4):
        xy = rng.uniform(0, 70, (i + 2, 2))
        wh = rng.uniform(4, 40, (i + 2, 2))
        boxes2d.append(np.concatenate([xy, xy + wh], 1).astype(np.float32))
        labels2d.append(rng.integers(0, 10, i + 2))
    boxes2d[1] = boxes2d[1][:0]
    labels2d[1] = labels2d[1][:0]
    np.testing.assert_array_equal(atss.atss_assign(anchors, boxes2d[3]),
                                  jatss.atss_assign(anchors, boxes2d[3]))
    a = np.concatenate(anchors)[:20]
    np.testing.assert_array_equal(atss.centerness_target(a, boxes2d[0][[0] * 20]),
                                  jatss.centerness_target(a, boxes2d[0][[0] * 20]))
    np.testing.assert_array_equal(atss.delta_encode(a, boxes2d[0][[0] * 20]),
                                  jatss.delta_encode(a, boxes2d[0][[0] * 20]))
    got = train.atss_targets(anchors, boxes2d, labels2d)
    want = jtrain.atss_targets(anchors, boxes2d, labels2d)
    assert want.num_pos > 10 and got.num_pos == float(want.num_pos)
    for x, y in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


def test_atss_loss_matches_jax():
    """Focal, centerness-weighted GIoU and centerness BCE on the head's
    outputs with the same targets, within 1e-5; the box decoding and the
    GIoU loss alone too."""
    jhead, params, head, feats, shapes = atss_pair(4)
    anchors = atss.grid_anchors(shapes)
    rng = np.random.default_rng(5)
    boxes2d = []
    for _ in range(2):
        xy = rng.uniform(0, 60, (4, 2))
        boxes2d.append(np.concatenate([xy, xy + rng.uniform(8, 40, (4, 2))], 1).astype(np.float32))
    labels2d = [rng.integers(0, 10, 4) for _ in range(2)]
    jtgt = jtrain.atss_targets(anchors, boxes2d, labels2d)
    want = jax.jit(lambda p, f: jtrain.atss_loss(jhead.apply({"params": p}, f), anchors, jtgt))(
        params, [jnp.asarray(f) for f in feats])
    with torch.no_grad():
        got = train.atss_loss(head([T(f).permute(0, 3, 1, 2) for f in feats]), anchors,
                              train.atss_targets(anchors, boxes2d, labels2d))
    assert got.keys() == want.keys()
    for k in want:
        close(got[k].numpy(), want[k], 1e-5)
    a = np.concatenate(anchors)[:50].astype(np.float32)
    d = rng.normal(0, 1, (50, 4)).astype(np.float32)
    dec = atss.delta_decode(T(a), T(d))
    close(dec.numpy(), jatss.delta_decode(jnp.asarray(a), jnp.asarray(d)), 1e-6)
    gt = np.repeat(boxes2d[0][:1], 50, 0)
    close(atss.giou_loss(dec, T(gt)).numpy(),
          jatss.giou_loss(jnp.asarray(dec.numpy()), jnp.asarray(gt)), 1e-6)


# ----------------------------------------------------------- DN, GridMask


def test_dn_mask_pack_and_loss_match_jax():
    """The attention mask exactly; prepare_dn with JAX's noise injected
    within 1e-6 (labels exactly); dn_loss within 1e-5."""
    for args in ((20, 12, 4, 24, 10), (6, 5, 2, 9, 3)):
        np.testing.assert_array_equal(denoise.build_dn_attn_mask(*args),
                                      jdenoise.build_dn_attn_mask(*args))
    rng = np.random.default_rng(6)
    boxes, labels = gt_batch(rng, 2, 5, [5, 2])
    key = jax.random.PRNGKey(7)
    jpack = jdenoise.prepare_dn(key, jnp.asarray(boxes), jnp.asarray(labels), num_query=12,
                                num_propagated=4, memory_len=24, pc_range=PC, scalar=4)
    pack = denoise.prepare_dn(T(boxes), T(labels), num_query=12, num_propagated=4,
                              memory_len=24, pc_range=PC, scalar=4,
                              rand_prob=T(dn_noise(key, 2, 20)))
    assert pack.pad_size == jpack.pad_size == 20
    for name in ("ref", "box_targets", "valid", "attn_mask"):
        close(getattr(pack, name).numpy(), getattr(jpack, name), 1e-6)
    np.testing.assert_array_equal(pack.labels.numpy(), np.asarray(jpack.labels))
    assert 0 < (np.asarray(jpack.labels) == 10).mean() < 1    # some flipped, some kept
    cls = rng.normal(0, 2, (3, 2, 20, 10)).astype(np.float32)
    reg = rng.normal(0, 2, (3, 2, 20, 10)).astype(np.float32)
    close(denoise.dn_loss(T(cls), T(reg), pack, PC).numpy(),
          jax.jit(lambda c, r: jdenoise.dn_loss(c, r, jpack, PC))(cls, reg), 1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_grid_mask_equals_jax_with_its_draws_injected(seed):
    imgs = np.random.default_rng(seed).standard_normal((2, 2, 3, 40, 56, 3)).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jgrid_mask(key, jnp.asarray(imgs)))
    k_apply, k_d, k_ox, k_oy = jax.random.split(key, 4)
    d = int(jax.random.randint(k_d, (), 2, 40))
    draws = GridDraws(bool(jax.random.bernoulli(k_apply, 0.7)), d,
                      int(jax.random.randint(k_ox, (), 0, d)),
                      int(jax.random.randint(k_oy, (), 0, d)))
    np.testing.assert_array_equal(grid_mask(T(imgs), draws=draws).numpy(), want)
    gen = torch.Generator().manual_seed(seed)
    out = grid_mask(T(imgs), generator=gen)
    assert out.shape == imgs.shape


# ------------------------------------------------------------------- head


def test_head_with_dn_pack_matches_jax():
    """The tiny head over two frames, the second with a DNPack: the DN and
    match slices, and a memory without the DN rows, within 1e-4."""
    rng = np.random.default_rng(8)
    b, n, h, w, c = 2, 2, 32, 64, 32
    cfg = dict(TINY, num_levels=2, num_cams=n)
    data = frame_data(rng, b, 2, n, h, w)
    feats = [[rng.standard_normal((b, n, h // s, w // s, c)).astype(np.float32) for s in (8, 16)]
             for _ in range(2)]
    boxes, labels = gt_batch(rng, b, 3, [3, 1])
    key = jax.random.PRNGKey(9)
    jpack = jdenoise.prepare_dn(key, jnp.asarray(boxes), jnp.asarray(labels), num_query=12,
                                num_propagated=8, memory_len=24, pc_range=PC, scalar=10)
    pack = denoise.prepare_dn(T(boxes), T(labels), num_query=12, num_propagated=8,
                              memory_len=24, pc_range=PC, scalar=10,
                              rand_prob=T(dn_noise(key, b, 30)))
    jhead = JSparseHead(**cfg)
    d = [{k: jnp.asarray(v[:, fi]) for k, v in data.items()} for fi in range(2)]
    params = init_random(jhead, 10, [jnp.asarray(f) for f in feats[0]], jinit_memory(b, 24, c),
                         d[0], (h, w))
    @jax.jit
    def two_frames(p, f0, f1, d0, d1):
        _, mem = jhead.apply({"params": p}, f0, jinit_memory(b, 24, c), d0, (h, w))
        return jhead.apply({"params": p}, f1, mem, d1, (h, w), dn=jpack)

    jouts, jmem = two_frames(params, *([jnp.asarray(f) for f in fs] for fs in feats), *d)
    head = SparseHead(**cfg)
    head.load_state_dict(sub_state(streampetr_state_dict_from_jax({"head": params}, num_layers=2),
                                   "pts_bbox_head."), strict=True)
    mem = init_memory(b, 24, c)
    with torch.no_grad():
        for fi, dn in ((0, None), (1, pack)):
            outs, mem = head([T(f).flatten(0, 1).permute(0, 3, 1, 2) for f in feats[fi]], mem,
                             {k: T(v[:, fi]) for k, v in data.items()}, (h, w), dn=dn)
    assert outs.keys() == jouts.keys()
    assert outs["dn_cls_scores"].shape == (2, b, 30, 10)
    assert outs["all_cls_scores"].shape == (2, b, 20, 10)
    for k in jouts:
        close(outs[k].numpy(), jouts[k], 1e-4)
    for field in jmem._fields:
        close(getattr(mem, field).numpy(), getattr(jmem, field), 1e-4)


def test_dn_masked_self_attention_gradient_matches_jax_grad():
    """The DN-masked self-attention (plain PyTorch, as XLA computes it in
    the JAX package) under a focal loss: the loss, and the gradients of
    the query, the key and every projection, against ``jax.grad`` within
    1e-5 of each gradient's largest value."""
    rng = np.random.default_rng(11)
    b, c, pad, q, p, m, scalar = 2, 32, 6, 5, 2, 7, 3
    mask = jdenoise.build_dn_attn_mask(pad, q, p, m, scalar)
    query = rng.standard_normal((b, pad + q + p, c)).astype(np.float32)
    key_ = rng.standard_normal((b, pad + q + m, c)).astype(np.float32)
    qpos = rng.standard_normal(query.shape).astype(np.float32)
    kpos = rng.standard_normal(key_.shape).astype(np.float32)
    w_cls = (rng.standard_normal((c, 10)) / math.sqrt(c)).astype(np.float32)
    labels = rng.integers(0, 11, (b, pad + q + p))
    jmod = JMHSA(embed_dims=c, num_heads=8)
    params = init_random(jmod, 12, jnp.asarray(query), jnp.asarray(key_), jnp.asarray(key_),
                         jnp.asarray(qpos), jnp.asarray(kpos))

    def jloss(prm, qu, ke):
        out = jmod.apply({"params": prm}, qu, ke, ke, jnp.asarray(qpos), jnp.asarray(kpos),
                         attn_bias=jnp.asarray(mask))
        return jlosses.sigmoid_focal_loss(out @ w_cls, jnp.asarray(labels), 10).sum()

    jl, (jg_p, jg_q, jg_k) = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        params, jnp.asarray(query), jnp.asarray(key_))
    flat = flatten({"m": params})
    sd = _packed_qkv(flat, ("m",), "attn")
    sd.update(apply_map(flat, _dense("attn.out_proj", ("m", "out_proj"))))
    mod = MultiheadSelfAttention(c, 8)
    mod.load_state_dict(sd, strict=True)
    qt, kt = T(query).requires_grad_(), T(key_).requires_grad_()
    out = mod(qt, kt, kt, T(qpos), T(kpos), attn_bias=T(mask))
    loss = train_losses.sigmoid_focal_loss(out @ T(w_cls), T(labels), 10).sum()
    loss.backward()
    close(loss.detach().numpy(), jl, 1e-5)
    close(qt.grad.numpy(), jg_q, 1e-5)
    close(kt.grad.numpy(), jg_k, 1e-5)
    jflat = flatten({"m": jax.tree.map(np.asarray, jg_p)})
    want = _packed_qkv(jflat, ("m",), "attn")
    want.update(apply_map(jflat, _dense("attn.out_proj", ("m", "out_proj"))))
    for name, prm in mod.named_parameters():
        close(prm.grad.numpy(), want[name].numpy(), 1e-5)


# -------------------------------------------------------------- detector


@pytest.fixture(scope="module")
def tiny_pair():
    """The tiny detector with the ATSS head (one stacked conv), its JAX
    twin's forwards: ``train_window`` over 2 frames with a DNPack and
    ``train_frame`` from a fresh memory, both in one jit."""
    rng = np.random.default_rng(13)
    b, t, n, h, w = 2, 2, 6, 32, 64
    kw = dict(TINY, backbone_cfg={"stage_blocks": BLOCKS}, with_atss=True, atss_stacked_convs=1)
    imgs = rng.standard_normal((b, t, n, h, w, 3)).astype(np.float32)
    data = frame_data(rng, b, t, n, h, w)
    boxes, labels = gt_batch(rng, b, 4, [4, 3])
    key = jax.random.PRNGKey(14)
    jmodel = jdetector.StreamPETRWindow(**kw)
    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    params = init_random(jmodel, 15, jnp.asarray(imgs), jdata, method=jmodel.train_window)
    jpack = jdenoise.prepare_dn(key, jnp.asarray(boxes), jnp.asarray(labels), num_query=12,
                                num_propagated=8, memory_len=24, pc_range=PC)

    @jax.jit
    def forwards(p, i, d):
        win = jmodel.apply({"params": p}, i, d, dn=jpack, method=jmodel.train_window)
        frame = jmodel.apply({"params": p}, i[:, 0], jinit_memory(b, 24, 32),
                             {k: v[:, 0] for k, v in d.items()}, dn=jpack,
                             method=jmodel.train_frame)
        return win, frame

    with_threads = torch.get_num_threads()
    torch.set_num_threads(2)
    jwin, jframe = forwards(params, jnp.asarray(imgs), jdata)
    model = detector.StreamPETRWindow(**kw).eval()
    model.load_state_dict(streampetr_state_dict_from_jax(params, num_layers=2, stage_blocks=BLOCKS,
                                                         atss_stacked_convs=1), strict=True)
    pack = denoise.prepare_dn(T(boxes), T(labels), num_query=12, num_propagated=8,
                              memory_len=24, pc_range=PC, rand_prob=T(dn_noise(key, b, 40)))
    tdata = {k: T(v) for k, v in data.items()}
    win = model.train_window(T(imgs), tdata, dn=pack)
    with torch.no_grad():
        frame = model.train_frame(T(imgs)[:, 0], init_memory(b, 24, 32),
                                  {k: v[:, 0] for k, v in tdata.items()}, dn=pack)
    torch.set_num_threads(with_threads)
    return dict(jwin=jwin, jframe=jframe, win=win, frame=frame, params=params, jpack=jpack,
                pack=pack, boxes=boxes, labels=labels, model=model,
                anchors=atss.grid_anchors(atss.fpn_shapes((h, w), 5)))


def compare_train_outputs(got, want):
    outs, atss_outs, mem = got
    jouts, jatss_outs, jmem = want
    assert outs.keys() == jouts.keys() and "dn_cls_scores" in outs
    for k in jouts:
        close(outs[k].detach().numpy(), jouts[k], 1e-4)
    assert len(atss_outs) == len(jatss_outs) == 5
    for g, w in zip(atss_outs, jatss_outs):
        for a, b in zip(g, w):
            close(a.detach().permute(0, 2, 3, 1).numpy(), b, 1e-4)
    for field in jmem._fields:
        close(getattr(mem, field).detach().numpy(), getattr(jmem, field), 1e-4)


def test_detector_train_window_matches_jax(tiny_pair):
    """``train_window`` (the history frame under no_grad, the last with DN
    and gradients): every output, the ATSS outputs and the memory within
    1e-4 of their largest value; the graph reaches the parameters."""
    compare_train_outputs(tiny_pair["win"], tiny_pair["jwin"])
    outs = tiny_pair["win"][0]
    assert outs["all_cls_scores"].requires_grad and outs["dn_bbox_preds"].requires_grad


def test_detector_train_frame_matches_jax(tiny_pair):
    compare_train_outputs(tiny_pair["frame"], tiny_pair["jframe"])


def test_whole_loss_matches_the_jax_loss_functions(tiny_pair):
    """The port's loss on the tiny detector's ``train_window`` outputs
    against the same terms composed from the JAX package's public loss
    functions (sigmoid_focal_loss, dn_loss, atss_loss) and its batched
    assigner on the same outputs: each term within 1e-5."""
    rng = np.random.default_rng(16)
    outs, atss_outs, _ = tiny_pair["win"]
    boxes, labels, anchors = tiny_pair["boxes"], tiny_pair["labels"], tiny_pair["anchors"]
    boxes2d, labels2d = [], []
    for i in range(12):
        g = int(rng.integers(0, 4))
        xy = rng.uniform(0, 100, (g, 2))
        boxes2d.append(np.concatenate([xy, xy + rng.uniform(6, 30, (g, 2))], 1).astype(np.float32))
        labels2d.append(rng.integers(0, 10, g))
    trainer = train.DetectorTrainer(PC, anchors_per_level=anchors)
    with torch.no_grad():
        total, got, assignment = trainer.loss(outs, atss_outs, tiny_pair["pack"], T(boxes),
                                              T(labels), train.atss_targets(anchors, boxes2d,
                                                                            labels2d))
    # the JAX side, on the same numbers
    j = {k: jnp.asarray(v.detach().numpy()) for k, v in outs.items()}
    gnorm = jnorm(jnp.asarray(boxes))
    n_layers, b, q = j["all_cls_scores"].shape[:3]
    lab_q, gn_q, mask_q, _, _ = jtrain.make_batched_assigner(PC, 10, 2.0, 0.25)(
        np.asarray(j["all_cls_scores"]).reshape(n_layers * b, q, -1),
        np.asarray(j["all_bbox_preds"]).reshape(n_layers * b, q, -1),
        np.broadcast_to(np.asarray(gnorm)[None], (n_layers,) + gnorm.shape).reshape(
            n_layers * b, 4, -1),
        np.broadcast_to(labels[None], (n_layers, b, 4)).reshape(n_layers * b, 4))
    np.testing.assert_array_equal(assignment.labels.reshape(n_layers * b, q), lab_q)
    lab_q, gn_q, mask_q = (x.reshape((n_layers, b, q) + x.shape[2:]) for x in (lab_q, gn_q, mask_q))
    jtgt = jtrain.atss_targets(anchors, boxes2d, labels2d)

    @jax.jit
    def jax_loss(j, jatss_outs):
        n_pos = np.maximum(mask_q.sum((1, 2)), 1.0)
        cls_l = jlosses.sigmoid_focal_loss(j["all_cls_scores"], jnp.asarray(lab_q), 10).sum((1, 2))
        diff = jnp.abs(j["all_bbox_preds"] - gn_q) * jnp.asarray(jlosses.CODE_WEIGHTS)
        diff = jnp.where(jnp.isfinite(diff), diff, 0.0)
        out = {"loss_cls": 2.0 * (cls_l / n_pos).sum(),
               "loss_bbox": 0.25 * ((diff.sum(-1) * mask_q).sum((1, 2)) / n_pos).sum(),
               "loss_dn": jdenoise.dn_loss(j["dn_cls_scores"], j["dn_bbox_preds"],
                                           tiny_pair["jpack"], PC)}
        out.update(jtrain.atss_loss(jatss_outs, anchors, jtgt))
        out["loss"] = sum(out.values())
        return out

    want = jax_loss(j, [tuple(jnp.asarray(x.detach().permute(0, 2, 3, 1).numpy()) for x in lvl)
                        for lvl in atss_outs])
    assert got.keys() == want.keys()
    assert float(want["loss_atss_bbox"]) > 0
    for k in want:
        close(got[k].numpy(), want[k], 1e-5)
    assert float(total) == float(got["loss"])


def test_state_dict_with_atss_round_trips_through_the_jax_converter(tiny_pair):
    """The port detector's state dict with the ATSS head, given to the JAX
    package's ``convert_streampetr_checkpoint(with_atss=True)``, gives back
    the JAX tree leaf for leaf, but for the ATSS ``scales`` that the JAX
    converter leaves unmapped (ROADMAP Queue C)."""
    sd = {k: v.numpy() for k, v in tiny_pair["model"].state_dict().items()}
    back, report = convert_streampetr_checkpoint(sd, num_layers=2, stage_blocks=BLOCKS,
                                                 with_atss=True, atss_stacked_convs=1)
    assert report["missing"] == []
    assert sorted(report["unexpected"]) == [f"img_roi_head.scales.{i}.scale" for i in range(5)]
    want = flax.traverse_util.flatten_dict(tiny_pair["params"])
    got = flax.traverse_util.flatten_dict(back)
    assert set(want) - set(got) == {("roi_head", "scales")}
    for k in got:
        np.testing.assert_array_equal(np.asarray(got[k]), want[k], err_msg=str(k))


# -------------------------------------------------------- optimizer, schedule


# (JAX path, port name, shape, frozen at frozen_stages 1, a backbone norm)
TREE = [(("backbone", "conv1", "kernel"), "img_backbone.conv1.weight", (3, 4), True, False),
        (("backbone", "bn1", "scale"), "img_backbone.bn1.weight", (4,), True, True),
        (("backbone", "bn1", "bias"), "img_backbone.bn1.bias", (4,), True, True),
        (("backbone", "layer1_0", "conv1", "kernel"), "img_backbone.layer1.0.conv1.weight",
         (4, 4), True, False),
        (("backbone", "layer2_0", "conv2", "kernel"), "img_backbone.layer2.0.conv2.weight",
         (4, 5), False, False),
        (("backbone", "layer2_0", "bn2", "scale"), "img_backbone.layer2.0.bn2.weight",
         (5,), False, True),
        (("backbone", "layer2_0", "ds_bn", "bias"), "img_backbone.layer2.0.downsample.1.bias",
         (5,), False, True),
        (("neck", "fpn_0", "kernel"), "img_neck.fpn_convs.0.conv.weight", (5, 6), False, False),
        (("head", "cls_branch", "layers_0", "bias"), "pts_bbox_head.cls_branches.0.0.bias",
         (6,), False, False)]
# the batch-norm statistics: flax parameters in the JAX package, buffers here
STATS = [("backbone", "bn1", "mean"), ("backbone", "layer2_0", "bn2", "var")]


@pytest.mark.parametrize("bn_trainable", [True, False])
@pytest.mark.parametrize("engaged", [False, True])
def test_optimizer_matches_optax_and_clips_only_trained_gradients(engaged, bn_trainable):
    """Four steps of the port's optimizer against JAX ``make_detector_optimizer``
    (stem and layer1 frozen, backbone at 0.1 x lr, clip 35, cosine schedule):
    with the clip not engaged, the port equals the JAX chain fed the
    gradients as they are; with it engaged, the JAX chain fed the same
    gradients with the frozen entries (frozen stages and batch-norm
    statistics) zeroed, and differs from the chain fed them as they are,
    which clips by a norm that counts the frozen gradients. Frozen
    parameters stay bit-equal."""
    rng = np.random.default_rng(17)
    values = {name: rng.standard_normal(shape).astype(np.float32)
              for _, name, shape, _, _ in TREE}
    sched_kw = dict(base_lr=4e-4, warmup_iters=2, total_iters=6)
    opt_kw = dict(weight_decay=0.01, backbone_lr_mult=0.1, grad_clip_norm=35.0,
                  backbone_frozen_stages=1, backbone_bn_trainable=bn_trainable)
    named = {n: torch.nn.Parameter(T(v.copy())) for n, v in values.items()}
    opt = train.DetectorOptimizer(named, schedule=train.cosine_schedule(**sched_kw), **opt_kw)
    frozen = {name for _, name, _, fz, bn in TREE if fz or (bn and not bn_trainable)}
    assert set(opt.frozen) == frozen
    assert all(not named[n].requires_grad for n in frozen)
    jopt = jtrain.make_detector_optimizer(schedule=jtrain.cosine_schedule(**sched_kw), **opt_kw)
    jupdate = jax.jit(jopt.update)

    def tree(vals, stats):
        out = {path: jnp.asarray(vals[name]) for path, name, _, _, _ in TREE}
        out.update({path: jnp.asarray(stats[path]) for path in STATS})
        return flax.traverse_util.unflatten_dict(out)

    stats0 = {p: rng.uniform(0.5, 1.5, 4 if p[1] == "bn1" else 5).astype(np.float32)
              for p in STATS}
    jparams = {"as_given": tree(values, stats0), "frozen_zeroed": tree(values, stats0)}
    jstate = {k: jopt.init(v) for k, v in jparams.items()}
    scale = 40.0 if engaged else 0.05
    for _ in range(4):
        g = {name: (rng.standard_normal(shape) * scale).astype(np.float32)
             for _, name, shape, _, _ in TREE}
        gstats = {p: (rng.standard_normal(stats0[p].shape) * scale).astype(np.float32)
                  for p in STATS}
        clipped = opt.step({n: T(g[n].copy()) for n in opt.params})
        assert bool(clipped) == engaged
        zeroed = {n: (np.zeros_like(v) if n in frozen else v) for n, v in g.items()}
        feeds = {"as_given": tree(g, gstats),
                 "frozen_zeroed": tree(zeroed, {p: np.zeros_like(v) for p, v in gstats.items()})}
        for k in jparams:
            upd, jstate[k] = jupdate(feeds[k], jstate[k], jparams[k])
            jparams[k] = optax.apply_updates(jparams[k], upd)
    flat = {k: flax.traverse_util.flatten_dict(v) for k, v in jparams.items()}
    moved = 0.0
    for path, name, _, _, _ in TREE:
        got = named[name].detach().numpy()
        if name in frozen:
            np.testing.assert_array_equal(got, values[name])
        close(got, flat["frozen_zeroed"][path], 1e-6)
        if not engaged:
            close(got, flat["as_given"][path], 1e-6)
        moved = max(moved, float(np.abs(np.asarray(flat["as_given"][path]) - got).max()))
    if engaged:    # the JAX norm counts the frozen gradients: another step size
        assert moved > 1e-6


def test_cosine_schedule_matches_optax():
    for kw in (dict(), dict(base_lr=1e-3, warmup_iters=0, total_iters=50),
               dict(warmup_iters=10, warmup_ratio=0.333333, total_iters=40, min_lr_ratio=0.01)):
        ours, theirs = train.cosine_schedule(**kw), jtrain.cosine_schedule(**kw)
        for c in (0, 1, 5, 9, 10, 11, 25, 39, 40, 41, 499, 500, 501, 20000, 42192, 50000):
            close(ours(c), theirs(c), 1e-6)


# -------------------------------------------------------------- datasets


def with_2d_annotations(infos, seed):
    """Per-camera 2D boxes in original pixels on every other frame, so both
    branches of window_with_gt run."""
    rng = np.random.default_rng(seed)
    for i, info in enumerate(infos):
        if i % 2:
            continue
        info["bboxes2d"], info["labels2d"] = [], []
        for _ in range(6):
            xy = rng.uniform(0, 1400, (3, 2))
            info["bboxes2d"].append(np.concatenate([xy, xy + rng.uniform(5, 300, (3, 2))], 1))
            info["labels2d"].append(rng.integers(0, 10, 3))
    return infos


def test_train_dataset_windows_and_gt_equal_jax_with_flip_and_rotation():
    """window_with_gt of the port and of the JAX dataset on the same
    synthetic infos (random history jitter, IDA resize and flip, global
    rotation and scale, 2D annotations on half the frames, the projection
    fallback on the other half): every array equal, each draw of the
    RandomState in step."""
    def loader(path):
        return np.full((32, 64, 3), float(len(path) % 255), np.float32)

    kw = dict(queue_length=3, final_dim=(32, 64), image_loader=loader, random_length=1,
              ida_aug={"resize_lim": (0.3, 0.36), "rand_flip": True},
              rot_range=(-0.3925, 0.3925), scale_ratio_range=(0.95, 1.05), seed=5)
    ours = PerceptionTrainDataset(infos=with_2d_annotations(make_synthetic_infos(num_frames=9,
                                                                                 seed=4), 1), **kw)
    ref = JTrainDataset(infos=with_2d_annotations(jax_infos(num_frames=9, seed=4), 1), **kw)
    draws, sample = [], ours._sample_ida
    ours._sample_ida = lambda: draws.append(sample()) or draws[-1]
    for i in list(range(9)) * 2:
        got, want = ours.window_with_gt(i, max_gt=8), ref.window_with_gt(i, max_gt=8)
        assert (got is None) == (want is None)
        if got is None:
            continue
        assert got[0].keys() == want[0].keys()
        for k in want[0]:
            np.testing.assert_array_equal(got[0][k], want[0][k], err_msg=k)
        for a, b in zip(got[1:3], want[1:3]):
            np.testing.assert_array_equal(a, b)
        for a_list, b_list in zip(got[3:], want[3:]):
            assert len(a_list) == len(b_list) == 6
            for a, b in zip(a_list, b_list):
                np.testing.assert_array_equal(a, b)
    assert {flip for _, flip in draws} == {True, False}
    assert ours.rng.randint(1 << 30) == ref.rng.randint(1 << 30)
    # the motion head's futures (pred_steps > 0), refused until the dense
    # family's training was ported: the same window with its trajectories
    got, want = ours.window_with_gt(5, pred_steps=6), ref.window_with_gt(5, pred_steps=6)
    assert len(got) == len(want) == 7 and got[5].shape == (1, 64, 6, 2)
    for a, b in zip(got[1:3] + got[5:], want[1:3] + want[5:]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def test_eval_dataset_flip_equals_jax():
    """``frame_inputs(flip=True)``: the image mirrored, lidar2img and the
    intrinsics updated, as the JAX dataset does."""
    def loader(path):
        rs = np.random.RandomState(len(path))
        return rs.uniform(0, 255, (32, 64, 3)).astype(np.float32)

    ours = GenNuScenesEvalDataset(infos=make_synthetic_infos(num_frames=3, seed=2),
                                  queue_length=2, final_dim=(32, 64), image_loader=loader)
    ref = JEvalDataset(infos=jax_infos(num_frames=3, seed=2), queue_length=2, final_dim=(32, 64),
                       image_loader=loader)
    for flip in (False, True):
        got, want = ours.frame_inputs(1, 2, flip=flip), ref.frame_inputs(1, 2, flip=flip)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_streaming_sampler_and_flags_equal_jax():
    tokens = ["a"] * 7 + ["b"] * 4 + ["c"] * 9
    for split in (1, 2, 3, "all"):
        np.testing.assert_array_equal(sequence_group_flags(tokens, split), jflags(tokens, split))
    flags = sequence_group_flags(tokens, 2)
    for kw in (dict(batch_size=2, seed=3), dict(batch_size=1, num_replicas=2, rank=1, seed=0),
               dict(batch_size=2, seed=1, exclude_groups={0, 4})):
        ours, ref = StreamingSampler(flags, **kw), JStreamingSampler(flags, **kw)
        assert [ours.next_batch() for _ in range(25)] == [ref.next_batch() for _ in range(25)]


# ------------------------------------------------------------- configs


@pytest.mark.parametrize("name", sorted(configs.PERCEPTION))
def test_perception_recipes_equal_the_yamls(name):
    with open(os.path.join(ROOT, "panacea_tpu", "configs", "perception", f"{name}.yaml")) as f:
        want = yaml.safe_load(f)
    assert configs.PERCEPTION[name] == want
    target = resolve_target(want["perception"]["detector"]["target"])
    assert target.__module__ == "panacea_tpu_torch.perception.detector"
    assert target.__name__ == want["perception"]["detector"]["target"].rsplit(".", 1)[1]
    cfg = copy.deepcopy(want["perception"]["detector"]["params"])
    cfg.update(TINY, backbone_cfg={"stage_blocks": BLOCKS})
    model = target(**cfg)
    assert model.with_atss and hasattr(model, "img_roi_head")
