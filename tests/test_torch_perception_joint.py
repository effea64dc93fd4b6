"""The port's joint 2D-to-3D heads (RoIAlign, QueryRoIHead,
JointStreamPETRHead, JointHead) and CascadeRoIHead against the JAX
package's, on the CPU.

Every parameter is drawn on the port's side (``test_torch_perception_zoo.
drawn``) and carried to the JAX modules through the port's ``convert``
maps walked backwards (``torch_parity.to_jax``). Inputs are numpy arrays
from a seed; the DN noise is the JAX draw, handed to the port. Tolerances,
stated per test: RoIAlign within 1e-5 of the largest value against the JAX
gather and a float64 per-bin transcription; the heads within 1e-4 (the
perception tests' tolerance); the validity masks equal. Torch and BLAS run
on two threads.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_perception import close, frame_data, torch_tree
from test_torch_perception_train import PC, T, dn_noise, gt_batch
from test_torch_perception_zoo import TINY, drawn, port_feats
from torch_parity import assert_same_state, to_jax, two_threads  # noqa: F401

from panacea_tpu.perception import cascade_roi as jcascade
from panacea_tpu.perception import denoise as jdenoise
from panacea_tpu.perception import joint_head as jjoint
from panacea_tpu.perception.head import init_memory as jinit_memory
from panacea_tpu_torch import convert
from panacea_tpu_torch.ops import attention as port_attention
from panacea_tpu_torch.perception import cascade_roi, denoise, joint_head
from panacea_tpu_torch.perception.head import init_memory

pytestmark = pytest.mark.usefixtures("two_threads")
QH = {"conv_out_channels": 48, "fc_out_channels": 24}


def naive_roi_align(feat, boxes, oh, ow, scale, g):
    """mmcv's RoIAlign(aligned=True) kernel, one sample point at a time, in
    float64: feat (M, H, W, C), boxes (M, P, 4) -> (M, P, oh, ow, C)."""
    m, h, w, c = feat.shape
    out = np.zeros((m, boxes.shape[1], oh, ow, c))
    for mi in range(m):
        for pi in range(boxes.shape[1]):
            x1, y1, x2, y2 = boxes[mi, pi].astype(np.float64) * scale - 0.5
            bin_h, bin_w = (y2 - y1) / oh, (x2 - x1) / ow
            for ph in range(oh):
                for pw in range(ow):
                    acc = np.zeros(c)
                    for iy in range(g):
                        for ix in range(g):
                            y = y1 + (ph + (iy + 0.5) / g) * bin_h
                            x = x1 + (pw + (ix + 0.5) / g) * bin_w
                            if y < -1.0 or y > h or x < -1.0 or x > w:
                                continue
                            y, x = min(max(y, 0.0), h - 1), min(max(x, 0.0), w - 1)
                            y0, x0 = int(np.floor(y)), int(np.floor(x))
                            y1_, x1_ = min(y0 + 1, h - 1), min(x0 + 1, w - 1)
                            wy, wx = y - y0, x - x0
                            acc += ((1 - wy) * (1 - wx) * feat[mi, y0, x0]
                                    + (1 - wy) * wx * feat[mi, y0, x1_]
                                    + wy * (1 - wx) * feat[mi, y1_, x0]
                                    + wy * wx * feat[mi, y1_, x1_])
                    out[mi, pi, ph, pw] = acc / (g * g)
    return out


def random_boxes(rng, shape, h, w, lo=8.0):
    """xyxy boxes in image pixels, at least ``lo`` wide and high."""
    x1 = rng.uniform(0, w - 2 * lo, shape)
    y1 = rng.uniform(0, h - 2 * lo, shape)
    return np.stack([x1, y1, x1 + rng.uniform(lo, w / 2, shape),
                     y1 + rng.uniform(lo, h / 2, shape)], -1).astype(np.float32)


@pytest.mark.parametrize("g", [1, 2, 3])
def test_roi_align_matches_jax_and_a_naive_transcription(g):
    """RoIAlign at 5 x 3 bins of 1, 2 and 3 samples a side: boxes inside,
    hanging off every edge, sub-pixel, and wholly outside the map."""
    rng = np.random.default_rng(0)
    feat = rng.standard_normal((2, 9, 13, 4)).astype(np.float32)
    boxes = np.stack([
        np.array([[18, 20, 150, 120], [-50, -40, 80, 65], [30.7, 10.2, 37.9, 19.8]], np.float32),
        np.array([[0, 0, 208, 144], [100, 60, 300, 250], [-600, -600, -500, -520]], np.float32)])
    want = jax.jit(lambda f, bx: jjoint.roi_align(f, bx, (5, 3), 1 / 16.0, g))(
        jnp.asarray(feat), jnp.asarray(boxes))
    got = joint_head.roi_align(T(feat).permute(0, 3, 1, 2), T(boxes), (5, 3), 1 / 16.0, g)
    got = got.permute(0, 1, 3, 4, 2).numpy()
    close(got, want, 1e-5)
    close(got, naive_roi_align(feat, boxes, 5, 3, 1 / 16.0, g), 1e-5)


@pytest.mark.parametrize("c", [16, 48])
def test_query_roi_head_matches_jax(c):
    """QueryRoIHead on 2 samples of 3 cameras, 5 proposals each (one
    invalid), widths 16 (a ConvModule to 48, then a BasicBlock) and 48 (two
    BasicBlocks): the references within 1e-4, the validity equal."""
    rng = np.random.default_rng(1)
    b, n, p, h, w = 2, 3, 5, 64, 128
    head = drawn(joint_head.QueryRoIHead(embed_dims=c, pc_range=PC, **QH), 2)
    params = to_jax(head, convert.query_roi_head_map("n", (), first_conv=c != 48))
    feat = rng.standard_normal((b, n, h // 16, w // 16, c)).astype(np.float32)
    boxes = random_boxes(rng, (b, n, p), h, w)
    valid = np.ones((b, n, p), np.float32)
    valid[0, 1, 2] = 0.0
    d = {k: v[:, 0] for k, v in frame_data(rng, b, 1, n, h, w).items()}
    jref, jok = jax.jit(lambda prm, *a: jjoint.QueryRoIHead(
        embed_dims=c, pc_range=PC, **QH).apply({"params": prm}, *a))(
        params, jnp.asarray(feat), jnp.asarray(boxes), jnp.asarray(valid),
        {k: jnp.asarray(v) for k, v in d.items()})
    with torch.no_grad():
        ref, ok = head(T(feat).flatten(0, 1).permute(0, 3, 1, 2), T(boxes), T(valid),
                       torch_tree(d))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    assert 0 < float(ok.sum()) < ok.numel()
    close(ref.numpy(), jref, 1e-4)


def joint_inputs(rng, b, n, p, h, w, c, frames):
    data = frame_data(rng, b, frames, n, h, w)
    data["proposal_boxes"] = random_boxes(rng, (b, frames, n, p), h, w)
    data["proposal_valid"] = (rng.uniform(0, 1, (b, frames, n, p)) > 0.1).astype(np.float32)
    feats = [[rng.standard_normal((b, n, h // s, w // s, c)).astype(np.float32) for s in (8, 16)]
             for _ in range(frames)]
    return data, feats


@pytest.mark.parametrize("with_dn", [False, True])
def test_joint_stream_petr_head_two_frames_matches_jax(monkeypatch, with_dn):
    """JointStreamPETRHead (2 layers, 8 propagated, depth_num 32) streaming 2
    frames of 2 cameras with 64 proposals each, so its 128 + 8 queries go
    to the flash route: the self-attention (Sq 136, Skv 152; with DN 30 + 136
    to 30 + 152 on the masked plain path) and the dense cross-attention (Sq
    136, with DN 166, to the 256 stride-8 tokens); with and without a DN
    pack sized for the 128 proposal queries. Outputs and memory within
    1e-4."""
    rng = np.random.default_rng(3)
    b, n, p, h, w, c = 2, 2, 64, 64, 128, 32
    cfg = dict(TINY, num_levels=2, num_cams=n, depth_num=32, pc_range=PC, query_head_cfg=QH)
    head = drawn(joint_head.JointStreamPETRHead(**cfg), 4)
    params = to_jax(head, convert.joint_streampetr_head_map("n", (), 2),
                    packed=convert.petr_packed("n", (), 2))
    assert_same_state(convert.joint_head_state_dict_from_jax(params, 2), head)
    jhead = jjoint.JointStreamPETRHead(**cfg)
    data, feats = joint_inputs(rng, b, n, p, h, w, c, 2)
    jpack = pack = None
    if with_dn:
        boxes, labels = gt_batch(rng, b, 3, [3, 1])
        key = jax.random.PRNGKey(5)
        jpack = jdenoise.prepare_dn(key, jnp.asarray(boxes), jnp.asarray(labels),
                                    num_query=n * p, num_propagated=8, memory_len=24,
                                    pc_range=PC, scalar=10)
        pack = denoise.prepare_dn(T(boxes), T(labels), num_query=n * p, num_propagated=8,
                                  memory_len=24, pc_range=PC, scalar=10,
                                  rand_prob=T(dn_noise(key, b, 30).copy()))
    run = jax.jit(lambda prm, f, m, d: jhead.apply({"params": prm}, f, m, d, (h, w), dn=jpack))
    calls, flash = [], port_attention.flash_attention

    def counted(q, k, v, **kw):
        calls.append((q.shape[1], k.shape[1]))
        return flash(q, k, v, **kw)

    monkeypatch.setattr(port_attention, "flash_attention", counted)
    jmem, mem = jinit_memory(b, 24, c), init_memory(b, 24, c)
    for fi in range(2):
        d = {k: v[:, fi] for k, v in data.items()}
        jouts, jmem = run(params, [jnp.asarray(f) for f in feats[fi]], jmem,
                          {k: jnp.asarray(v) for k, v in d.items()})
        with torch.no_grad():
            outs, mem = head(port_feats(feats[fi]), mem, torch_tree(d), (h, w), dn=pack)
        assert outs.keys() == jouts.keys()
        assert outs["all_cls_scores"].shape == (2, b, n * p + 8, 10)
        for k in jouts:
            close(outs[k].numpy(), jouts[k], 1e-4)
        for field in jmem._fields:
            close(getattr(mem, field).numpy(), getattr(jmem, field), 1e-4)
    want = [(166, 256)] * 4 if with_dn else [(136, 152), (136, 256)] * 4
    assert calls == want


def test_joint_head_matches_jax():
    """JointHead ('seed': the lifted proposals first, the learned points up
    to num_query 12 after) streaming 2 frames of 2 cameras with 4 proposals
    each: outputs and memory within 1e-4."""
    rng = np.random.default_rng(6)
    b, n, p, h, w, c = 2, 2, 4, 64, 128, 32
    cfg = dict(TINY, num_levels=2, num_cams=n, pc_range=PC, query_head_cfg=QH)
    head = drawn(joint_head.JointHead(**cfg), 7)
    params = to_jax(head, convert.joint_head_map("n", (), 2),
                    packed=convert.petr_packed("n", (), 2, cross=False))
    assert_same_state(convert.joint_head_state_dict_from_jax(params, 2, "JointHead"), head)
    jhead = jjoint.JointHead(**cfg)
    data, feats = joint_inputs(rng, b, n, p, h, w, c, 2)
    run = jax.jit(lambda prm, f, m, d: jhead.apply({"params": prm}, f, m, d, (h, w)))
    jmem, mem = jinit_memory(b, 24, c), init_memory(b, 24, c)
    for fi in range(2):
        d = {k: v[:, fi] for k, v in data.items()}
        jouts, jmem = run(params, [jnp.asarray(f) for f in feats[fi]], jmem,
                          {k: jnp.asarray(v) for k, v in d.items()})
        with torch.no_grad():
            outs, mem = head(port_feats(feats[fi]), mem, torch_tree(d), (h, w))
        assert outs["all_cls_scores"].shape == (2, b, 12 + 8, 10)
        for k in jouts:
            close(outs[k].numpy(), jouts[k], 1e-4)
        for field in jmem._fields:
            close(getattr(mem, field).numpy(), getattr(jmem, field), 1e-4)


def test_cascade_roi_head_matches_jax():
    """CascadeRoIHead (3 stages, 1024-wide FCs, 7 x 7 RoIs of 16 channels)
    on 3 images with 6 boxes each, one invalid: every stage's logits, deltas
    and boxes and the averaged scores within 1e-4; the first FC's weight
    crosses from the JAX channels-last flattening to mmdet's."""
    rng = np.random.default_rng(8)
    m, p, c, h, w = 3, 6, 16, 64, 128
    head = drawn(cascade_roi.CascadeRoIHead(in_channels=c), 9)
    params = to_jax(head, convert.cascade_roi_map("n", (), in_channels=c))
    feat = rng.standard_normal((m, h // 16, w // 16, c)).astype(np.float32)
    boxes = random_boxes(rng, (m, p), h, w)
    valid = np.ones((m, p), np.float32)
    valid[1, 4] = 0.0
    want = jax.jit(lambda prm, *a: jcascade.CascadeRoIHead().apply({"params": prm}, *a))(
        params, jnp.asarray(feat), jnp.asarray(boxes), jnp.asarray(valid))
    with torch.no_grad():
        got = head(T(feat).permute(0, 3, 1, 2), T(boxes), T(valid))
    for k in ("cls_scores", "boxes"):
        close(got[k].numpy(), want[k], 1e-4)
    for k in ("stage_cls", "stage_boxes", "stage_reg"):
        for g, j in zip(got[k], want[k]):
            close(g.numpy(), j, 1e-4)
