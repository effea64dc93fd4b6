"""The port's FocalHead with its 2D losses, the EVA and Sparse4Dv3
detectors, their converter and the training CLI with EVA and SparseHeadv3
against the JAX package's, on the CPU.

Every parameter is drawn on the port's side (``test_torch_perception_zoo.
drawn``) and carried to the JAX modules by the JAX package's own
``convert_streampetr_checkpoint`` (FocalHead through ``convert.
focal_head_map`` walked backwards). Inputs and ground truth are numpy
arrays from a seed. FocalHead's 2D Hungarian matching runs on the same
detached numbers in both packages (the test checks the targets are
equal). Tolerances, stated per test: the detectors within 1e-4 of each
output's largest value (the perception tests' tolerance), FocalHead and
its losses within 1e-5. Torch and BLAS run on two threads.
"""

import copy
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from test_torch_perception import close, frame_data, torch_tree
from test_torch_perception_proposals import EVA, EVA_MAP, proposals, to_jax_detector
from test_torch_perception_train import T
from test_torch_perception_zoo import TINY, drawn
from torch_parity import to_jax, two_threads  # noqa: F401

from panacea_tpu.perception import detector as jdetector
from panacea_tpu.perception import focal_head as jfocal
from panacea_tpu.perception import focal_train as jfocal_train
from panacea_tpu.perception.head import init_memory as jinit_memory
from panacea_tpu.utils.convert import convert_eva_pos_embed, convert_streampetr_checkpoint
from panacea_tpu_torch import convert
from panacea_tpu_torch.configs import PERCEPTION
from panacea_tpu_torch.convert import streampetr_state_dict_from_jax
from panacea_tpu_torch.perception import (detector, eval as peval, focal_head, focal_train,
                                          sparse_head_v3, train_cli)

pytestmark = pytest.mark.usefixtures("two_threads")


def test_focal_head_outputs_and_top_k_match_jax():
    """FocalHead (embed 64, GroupNorm of 32 groups) on a (2, 3, 4, 8, 48)
    level: the class logits, boxes, centres and centerness within 1e-5, and
    the top half of the 96 tokens (``infer_ratio`` 0.5) the same indices in
    the same order; a ``sample_ratio`` of 0.25 too."""
    rng = np.random.default_rng(26)
    b, n, h, w, cin = 2, 3, 4, 8, 48
    feat = rng.standard_normal((b, n, h, w, cin)).astype(np.float32)
    head = drawn(focal_head.FocalHead(in_channels=cin, embed_dims=64), 27)
    params = to_jax(head, convert.focal_head_map("n", ()))
    jhead = jfocal.FocalHead(embed_dims=64)
    for ratio in (None, 0.25):
        want = jhead.apply({"params": params}, jnp.asarray(feat), sample_ratio=ratio)
        with torch.no_grad():
            got = head(T(feat).flatten(0, 1).permute(0, 3, 1, 2), n, sample_ratio=ratio)
        assert got.keys() == want.keys()
        assert got["topk_indexes"].shape == (b, int(n * h * w * (ratio or 0.5)), 1)
        np.testing.assert_array_equal(got["topk_indexes"].numpy(), want["topk_indexes"])
        for k in ("enc_cls_scores", "enc_bbox_preds", "pred_centers2d", "centerness"):
            close(got[k].numpy(), want[k], 1e-5)


def gt_2d(rng, n_img, img_hw):
    """Per image 0 to 3 pixel xyxy boxes inside the image, labels, and
    centres inside their boxes."""
    h, w = img_hw
    boxes, labels, centers = [], [], []
    for i in range(n_img):
        g = i % 4
        x1, y1 = rng.uniform(0, w - 20, g), rng.uniform(0, h - 20, g)
        bw, bh = rng.uniform(8, 20, g), rng.uniform(8, 20, g)
        boxes.append(np.stack([x1, y1, x1 + bw, y1 + bh], -1).astype(np.float32))
        labels.append(rng.integers(0, 10, g))
        centers.append(np.stack([x1 + bw * rng.uniform(0.3, 0.7, g),
                                 y1 + bh * rng.uniform(0.3, 0.7, g)], -1).astype(np.float32))
    return boxes, labels, centers


def test_focal_targets_and_losses_match_jax():
    """The 2D Hungarian targets and heatmaps of the port equal the JAX
    host function's on the same detached outputs, and the five FocalHead
    losses (quality focal, L1, GIoU, centres, Gaussian focal centerness)
    are within 1e-5; the quality and Gaussian focal losses also
    elementwise."""
    rng = np.random.default_rng(28)
    b, n, img_hw = 2, 3, (64, 128)
    h, w = img_hw[0] // 16, img_hw[1] // 16
    feat = rng.standard_normal((b, n, h, w, 32)).astype(np.float32)
    head = drawn(focal_head.FocalHead(in_channels=32, embed_dims=32), 29)
    with torch.no_grad():
        outs = head(T(feat).flatten(0, 1).permute(0, 3, 1, 2), n)
    boxes, labels, centers = gt_2d(rng, b * n, img_hw)
    padded = focal_train.pad_gt_2d(boxes, labels, centers)
    for a, j in zip(padded, jfocal_train.pad_gt_2d(boxes, labels, centers)):
        np.testing.assert_array_equal(a, j)
    lw = {"cls": 2.0, "bbox": 5.0, "iou": 2.0, "centers2d": 10.0, "centerness": 2.0}
    det = [outs[k].numpy() for k in ("enc_cls_scores", "enc_bbox_preds", "pred_centers2d")]
    got = focal_train.make_focal_targets_host(img_hw, 10, lw)(*det, *padded)
    want = jfocal_train.make_focal_targets_host(img_hw, 10, lw)(*det, *padded)
    assert float(got[5]) == float(want[5]) > 0
    for a, j in zip(got, want):
        np.testing.assert_array_equal(a, j)
    losses = focal_train.focal_head_loss(outs, boxes, labels, centers, img_hw)
    jlosses = jax.jit(lambda o: jfocal_train.focal_head_loss(o, *padded, img_hw))(
        {k: jnp.asarray(v.numpy()) for k, v in outs.items() if k != "topk_indexes"})
    assert losses.keys() == jlosses.keys()
    for k in jlosses:
        close(losses[k].numpy(), jlosses[k], 1e-5)
    logits = rng.normal(0, 3, (40, 10)).astype(np.float32)
    lab = rng.integers(0, 11, 40)
    score = rng.uniform(0, 1, 40).astype(np.float32)
    close(focal_train.quality_focal_loss(T(logits), T(lab), T(score), 10).numpy(),
          jfocal_train.quality_focal_loss(jnp.asarray(logits), jnp.asarray(lab),
                                          jnp.asarray(score), 10), 1e-5)
    pred = rng.uniform(0.01, 0.99, (30,)).astype(np.float32)
    tgt = np.where(rng.random(30) < 0.2, 1.0, rng.uniform(0, 1, 30)).astype(np.float32)
    close(focal_train.gaussian_focal_loss(T(pred), T(tgt)).numpy(),
          jfocal_train.gaussian_focal_loss(jnp.asarray(pred), jnp.asarray(tgt)), 1e-5)


# ------------------------------------------------------ whole detectors


def test_eva_sparse_window_matches_jax():
    """``StreamPETRWindow(backbone_type='eva', num_levels=4)`` (a 3-block
    EVA of width 64, its adapter the neck) with the tiny SparseHead over a
    2-frame window of 6 cameras at 64 x 128: scores, boxes and the memory
    within 1e-4; with the default 5 levels both packages refuse."""
    rng = np.random.default_rng(31)
    b, t, n, h, w = 1, 2, 6, 64, 128
    imgs = rng.standard_normal((b, t, n, h, w, 3)).astype(np.float32)
    data = frame_data(rng, b, t, n, h, w)
    kw = dict(backbone_type="eva", num_levels=4, neck_start_level=0, **TINY)
    model = drawn(detector.StreamPETRWindow(backbone_cfg=dict(EVA, img_size=(h, w)), **kw), 32)
    assert model.img_neck is None and model.feat_strides == (4, 8, 16, 32)
    params = to_jax_detector(model.state_dict(), backbone="eva", head="sparse")
    jmodel = jdetector.StreamPETRWindow(backbone_cfg=EVA, **kw)
    jouts, jmem = jax.jit(lambda p, i, d: jmodel.apply({"params": p}, i, d))(
        params, jnp.asarray(imgs), {k: jnp.asarray(v) for k, v in data.items()})
    with torch.no_grad():
        outs, mem = model(T(imgs), torch_tree(data))
    for k in jouts:
        close(outs[k].numpy(), jouts[k], 1e-4)
    for field in jmem._fields:
        close(getattr(mem, field).numpy(), getattr(jmem, field), 1e-4)
    five = detector.StreamPETRWindow(backbone_type="eva", backbone_cfg=dict(EVA, img_size=(h, w)),
                                     **TINY)
    with pytest.raises(ValueError, match="eva neck gave 4 levels, the head takes num_levels 5"):
        five.extract_feats(T(imgs[:, 0]))


def test_sparse4dv3_streams_proposals_like_jax():
    """``Sparse4Dv3`` (r50 with one block a stage, the FPN, the tiny
    SparseHeadv3) streaming two frames of 6 cameras at 64 x 128 with 10
    proposals a frame: scores, boxes and the memory of each frame within
    1e-4; the drivers take their heads."""
    rng = np.random.default_rng(33)
    b, t, n, h, w, p = 1, 2, 6, 64, 128, 10
    imgs = rng.standard_normal((b, t, n, h, w, 3)).astype(np.float32)
    data = frame_data(rng, b, t, n, h, w)
    for k, v in proposals(rng, b * t, p, 32).items():
        data[k] = v.reshape((b, t) + v.shape[1:])
    kw = dict(backbone_cfg={"stage_blocks": (1, 1, 1, 1)}, **TINY)
    model = drawn(detector.Sparse4Dv3(**kw), 34)
    assert type(model.pts_bbox_head) is sparse_head_v3.SparseHeadv3
    params = to_jax_detector(model.state_dict())
    jmodel = jdetector.Sparse4Dv3(**kw)
    run = jax.jit(lambda prm, i, d, m: jmodel.apply({"params": prm}, i, d, m,
                                                    method=jmodel.stream))
    jmem, mem = None, None
    for fi in range(t):
        d = {k: v[:, fi] for k, v in data.items()}
        jouts, jmem = run(params, jnp.asarray(imgs[:, fi]),
                          {k: jnp.asarray(v) for k, v in d.items()},
                          jmem if jmem is not None else jinit_memory(b, 24, 32))
        with torch.no_grad():
            outs, mem = model.stream(T(imgs[:, fi]), torch_tree(d), mem)
        assert outs["all_cls_scores"].shape == (2, b, p + 8, 10)
        for k in jouts:
            close(outs[k].numpy(), jouts[k], 1e-4)
        for field in jmem._fields:
            close(getattr(mem, field).numpy(), getattr(jmem, field), 1e-4)
    for cls, head in ((detector.Sparse4D, "sparse"), (detector.Sparse4Dv2, "sparse"),
                      (detector.Sparse4Dv3, "sparse_v3")):
        assert cls.HEAD_TYPE == head and hasattr(cls, "stream")


# ------------------------------------------------------------ converter


def test_mmdet_named_eva_v3_state_dict_loads_by_name(tmp_path, capsys):
    """An EVA + SparseHeadv3 + ATSS detector's state dict, written as a
    reference ``.pth`` with EVA's position table in the reference's (1, 1 +
    n, C) form at a 6 x 6 pretrain grid: it loads by name into the port
    with nothing missing and nothing unexpected, the table resized to the
    4 x 8 grid as ``get_abs_pos`` resizes it. The same names, at the
    working grid, go through the JAX converter and back through
    ``streampetr_state_dict_from_jax`` with every tensor equal."""
    kw = dict(backbone_type="eva", head_type="sparse_v3", num_levels=4, with_atss=True,
              atss_stacked_convs=1, backbone_cfg=dict(EVA, img_size=(64, 128)), **TINY)
    src = drawn(detector.StreamPETRWindow(**kw), 35)
    sd = src.state_dict()
    table = torch.randn(1, 1 + 36, 64, generator=torch.Generator().manual_seed(36))
    written = dict(sd, **{"img_backbone.pos_embed": table})
    torch.save({"state_dict": written, "meta": {}}, tmp_path / "eva_v3.pth")
    dst = detector.StreamPETRWindow(**kw)
    report = peval.load_reference_checkpoint(dst, str(tmp_path / "eva_v3.pth"))
    assert report == {"restored": len(sd), "missing": 0, "unexpected": 0}
    got = dst.state_dict()
    want_pos = torch.nn.functional.interpolate(
        table[:, 1:].reshape(1, 6, 6, 64).permute(0, 3, 1, 2), size=(4, 8), mode="bicubic",
        align_corners=False).permute(0, 2, 3, 1)
    torch.testing.assert_close(got["img_backbone.pos_embed"], want_pos, rtol=0, atol=0)
    assert all(torch.equal(got[k], sd[k]) for k in sd if k != "img_backbone.pos_embed")
    assert "0 missing, 0 unexpected" in capsys.readouterr().out

    params, report = convert_streampetr_checkpoint(
        {k: v.numpy() for k, v in written.items()}, num_layers=2, backbone="eva",
        head="sparse_v3", with_atss=True, atss_stacked_convs=1,
        eva_cfg=dict(EVA_MAP, grid_hw=(4, 8)))
    # the JAX converter leaves the ATSS scales unmapped (ROADMAP Queue C)
    assert report["missing"] == [] and all(k.startswith("img_roi_head.scales.")
                                           for k in report["unexpected"])
    back = streampetr_state_dict_from_jax(params, num_layers=2, atss_stacked_convs=1,
                                          backbone="eva", head="sparse_v3")
    assert back.keys() == {k for k in sd if not k.startswith("img_roi_head.scales.")}
    for k in back:
        if k != "img_backbone.pos_embed":
            assert torch.equal(back[k], sd[k]), k
    # the JAX converter resizes the table with jax.image.resize's bicubic
    np.testing.assert_array_equal(back["img_backbone.pos_embed"].numpy(),
                                  convert_eva_pos_embed(table.numpy(), (4, 8)))


# ------------------------------------------------------------- training


EVA_YAML = dict(backbone_type="eva", num_levels=4, neck_start_level=0,
                backbone_cfg={"width": 64, "heads": 4, "layers": 2, "window_size": 2,
                              "window_block_indexes": [0]})
R50_YAML = dict(backbone_cfg={"stage_blocks": [1, 1, 1, 1]})


@pytest.mark.parametrize("params, head", [(EVA_YAML, "sparse_v3"), (R50_YAML, "sparse_v4")],
                         ids=["eva_sparse_v3", "r50_sparse_v4"])
def test_training_cli_trains_eva_and_the_proposal_query_heads(tmp_path, params, head):
    """Two steps of the training CLI at the window recipe from a written
    YAML, with a 2-block EVA (``num_levels: 4``) and ``head_type:
    sparse_v3``, or r50 and ``sparse_v4``: the JAX CLI's train-log keys,
    every term finite; nothing of EVA frozen and EVA at the backbone's
    learning-rate multiplier."""
    cfg = copy.deepcopy(PERCEPTION["streampetr_r50_atss_512x256_window"])
    cfg["perception"]["detector"]["params"].update(params, head_type=head)
    config = tmp_path / "zoo.yaml"
    config.write_text(yaml.safe_dump(cfg))
    log = train_cli.main(["--synthetic", "--tiny", "--device", "cpu", "--workdir", str(tmp_path),
                          "--queue_length", "2", "--final_dim", "32", "64", "--config",
                          str(config), "--steps", "2"])
    with open(tmp_path / "zoo" / "train_log.json") as f:
        written = json.load(f)
    assert written["steps"] == 2 and written["final_metrics"].keys() == {
        "loss", "loss_cls", "loss_bbox", "loss_dn", "loss_atss_cls", "loss_atss_bbox",
        "loss_atss_ctr"}
    assert all(math.isfinite(v) for v in written["final_metrics"].values())
    state = log["state"]
    assert state.model.head_type == head
    if params is EVA_YAML:
        assert state.model.backbone_type == "eva"
        assert not any(k.startswith("img_backbone.") for k in state.optimizer.frozen)
        groups = {g["lr"]: set(g["names"]) for g in state.optimizer.adamw.groups}
        assert groups == {0.1: {k for k in state.params if k.startswith("img_backbone.")},
                          1.0: {k for k in state.params if not k.startswith("img_backbone.")}}
        assert any(k.startswith("img_backbone.blocks.1.") for k in groups[0.1])
