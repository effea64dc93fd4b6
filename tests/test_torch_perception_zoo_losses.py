"""The losses of the rest of the perception zoo, the vector-map AP and the
eval filters of the port against the JAX package's, on the CPU.

The heads' outputs are the port modules' on drawn weights (or seeded
arrays), handed to both packages' loss functions as the same numbers; the
DN noise is the JAX draw. Tolerances, stated per test: every loss term
within 1e-5 of its value; the host's NumPy (rotated IoU, MaxIoU
assignment, the FCOS and SimOTA targets, AP, the filters) exactly equal;
the IoU3D targets, which decode the fp32 box code first, within 1e-5.
Torch and BLAS run on two threads.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_perception import close
from test_torch_perception_train import PC, T, dn_noise, gt_batch
from test_torch_perception_zoo import drawn
from torch_parity import two_threads  # noqa: F401

from panacea_tpu.perception import cascade_roi as jcascade
from panacea_tpu.perception import denoise as jdenoise
from panacea_tpu.perception import eval_filters as jfilters
from panacea_tpu.perception import fcos_proposal as jfcos
from panacea_tpu.perception import joint_head as jjoint
from panacea_tpu.perception import simmod as jsimmod
from panacea_tpu.perception import vector_metrics as jvector
from panacea_tpu.perception import vestigial_train as jvestigial
from panacea_tpu.perception import yolox_head as jyolox
from panacea_tpu_torch.perception import (cascade_roi, denoise, eval_filters, fcos_proposal,
                                          joint_head, simmod, vector_metrics, vestigial_train,
                                          yolox_head)

pytestmark = pytest.mark.usefixtures("two_threads")


def jtree(x):
    """A port output tree as the JAX package's arrays."""
    if isinstance(x, dict):
        return {k: jtree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(jtree(v) for v in x)
    return jnp.asarray(x.detach().numpy()) if isinstance(x, torch.Tensor) else x


def assert_terms(got, want, tol=1e-5):
    assert got.keys() == want.keys(), (sorted(got), sorted(want))
    for k in want:
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]), rtol=tol, atol=tol,
                                   err_msg=k)


# ------------------------------------------------------------- SimMOD


def boxes3d(rng, n):
    """(N, 7) boxes (cx, cy, cz_bottom, w, l, h, yaw)."""
    return np.concatenate([rng.uniform(-3, 3, (n, 3)), rng.uniform(0.5, 4, (n, 3)),
                           rng.uniform(-np.pi, np.pi, (n, 1))], -1)


def test_rotated_iou_3d_matches_jax_exactly():
    """Paired rotated 3D IoU of 60 random pairs, a box with itself (1), a
    box and a disjoint one (0), and a box and its 90 degree turn: equal."""
    rng = np.random.default_rng(0)
    a, b = boxes3d(rng, 60), boxes3d(rng, 60)
    a[0], b[0] = a[1], a[1]
    b[1] = a[1] + [50, 0, 0, 0, 0, 0, 0]
    b[2] = a[2] + [0, 0, 0, 0, 0, 0, np.pi / 2]
    got = vestigial_train.rotated_iou_3d(a, b)
    np.testing.assert_array_equal(got, jvestigial.rotated_iou_3d(a, b))
    assert got[0] == pytest.approx(1.0) and got[1] == 0.0 and 0 < got[2] < 1


def simmod_inputs(rng, layers=2, b=3, q=20, code=11):
    cls = rng.normal(-2, 2, (layers, b, q, 10)).astype(np.float32)
    reg = rng.normal(0, 1, (layers, b, q, code)).astype(np.float32)
    counts = (4, 0, 2)
    boxes, labels = gt_batch(rng, b, 4, list(counts))
    boxes_list = [boxes[i, :g] for i, g in enumerate(counts)]
    labels_list = [labels[i, :g] for i, g in enumerate(counts)]
    boxes_list[2][1, 7] = np.nan          # a box with no velocity
    # the predictions near the matched boxes, so that the IoUs are not all 0
    for i, g in enumerate(counts):
        for j in range(g):
            bx = np.nan_to_num(boxes_list[i][j])
            reg[:, i, j, :3] = bx[:3] + rng.normal(0, 0.4, 3)
            reg[:, i, j, 3:6] = np.log(bx[3:6]) + rng.normal(0, 0.3, 3)
            reg[:, i, j, 6:8] = np.sin(bx[6]), np.cos(bx[6])
    return cls, reg, boxes_list, labels_list


def test_simmod_iou3d_targets_and_simmod_loss_match_jax():
    """The IoU3D targets of the matched rows within 1e-5 (some inside (0,
    1), some clipped); then ``simmod_loss`` with the IoU3D branch (code
    size 11), with and without pinned queries, and a bg_cls_weight: every
    term within 1e-5; code size 10 with the branch raises in both."""
    rng = np.random.default_rng(1)
    cls, reg, boxes_list, labels_list = simmod_inputs(rng)
    labels, tgts, pos, _, _ = jvestigial.detr3d_layer_targets(cls[0], reg[0][..., :10],
                                                              boxes_list, labels_list, 10)
    got = vestigial_train.simmod_iou3d_targets(reg[0], tgts, pos)
    want = jvestigial.simmod_iou3d_targets(reg[0], tgts, pos)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert ((got > 0) & (got < 1)).any()
    pins = [np.array([3] + [-1] * 19), np.full(20, -1), np.array([-1, 0, 0] + [-1] * 17)]
    outs = {"all_cls_scores": T(cls), "all_bbox_preds": T(reg)}
    for pre in (None, pins):
        got = simmod.simmod_loss(outs, boxes_list, labels_list, pre_assigns_list=pre,
                                 compute_loss_iou3d=True, iou3d_weight=0.5, bg_cls_weight=0.1)
        want = jsimmod.simmod_loss(jtree(outs), boxes_list, labels_list, pre_assigns_list=pre,
                                   compute_loss_iou3d=True, iou3d_weight=0.5, bg_cls_weight=0.1)
        assert {"loss_iou3d", "d0.loss_iou3d"} <= set(got)
        assert_terms(got, want)
    short = {"all_cls_scores": T(cls), "all_bbox_preds": T(reg[..., :10])}
    with pytest.raises(ValueError, match="code_size 11"):
        simmod.simmod_loss(short, boxes_list, labels_list, compute_loss_iou3d=True)
    with pytest.raises(AssertionError, match="code_size=11"):
        jsimmod.simmod_loss(jtree(short), boxes_list, labels_list, compute_loss_iou3d=True)


def test_fcos_targets_and_loss_match_jax():
    """``fcos_targets`` on 2 levels of 4 images (a small and a large box, an
    empty image, two overlapping boxes with depths; without depths too):
    equal; then ``fcos_loss`` on a drawn FCOS head's outputs: every term
    within 1e-5."""
    rng = np.random.default_rng(2)
    sizes, strides = [(8, 16), (4, 8)], [8, 16]
    gt_b = [np.array([[30.0, 20.0, 60.0, 50.0]], np.float32),
            np.array([[4.0, 0.0, 124.0, 60.0]], np.float32), np.zeros((0, 4), np.float32),
            np.array([[10.0, 10.0, 50.0, 40.0], [20.0, 15.0, 60.0, 55.0]], np.float32)]
    gt_l = [np.array([2]), np.array([3]), np.zeros((0,), np.int64), np.array([1, 7])]
    gt_d = [np.array([12.0]), np.array([30.0]), np.zeros((0,)), np.array([8.0, 9.5])]
    for depths in (gt_d, None):
        got = fcos_proposal.fcos_targets(sizes, strides, gt_b, gt_l, depths)
        want = jfcos.fcos_targets(sizes, strides, gt_b, gt_l, depths)
        for a, r in zip(got, want):
            np.testing.assert_array_equal(a, r)
    assert got[4] > 0
    head = drawn(fcos_proposal.FCOSProposalHead(in_channels=16, feat_channels=16,
                                                stacked_convs=1, cls_branch=(16,),
                                                strides=tuple(strides)), 3)
    feats = [T(rng.standard_normal((4, 16, h, w)).astype(np.float32)) for h, w in sizes]
    with torch.no_grad():
        outs = head(feats)
    targets = fcos_proposal.fcos_targets(sizes, strides, gt_b, gt_l, gt_d)
    got = fcos_proposal.fcos_loss(outs, targets)
    want = jfcos.fcos_loss([{k: jnp.asarray(v.permute(0, 2, 3, 1).numpy()) for k, v in o.items()}
                            for o in outs], targets)
    assert_terms(got, want)


# ------------------------------------------------------------ the joint heads


def test_joint_family_loss_with_dn_matches_jax():
    """``joint_family_loss`` on seeded outputs of 2 layers with DN rows (a
    pack of 3 and 1 boxes at scalar 10): every term, ``loss_dn`` among
    them, within 1e-5; without the pack no DN term."""
    rng = np.random.default_rng(4)
    cls, reg, boxes_list, labels_list = simmod_inputs(rng, code=10)
    boxes, labels = gt_batch(rng, 3, 3, [3, 1, 0])
    key = jax.random.PRNGKey(5)
    jpack = jdenoise.prepare_dn(key, jnp.asarray(boxes), jnp.asarray(labels), num_query=20,
                                num_propagated=8, memory_len=24, pc_range=PC, scalar=10)
    pack = denoise.prepare_dn(T(boxes), T(labels), num_query=20, num_propagated=8, memory_len=24,
                              pc_range=PC, scalar=10, rand_prob=T(dn_noise(key, 3, 30).copy()))
    outs = {"all_cls_scores": T(cls), "all_bbox_preds": T(reg),
            "dn_cls_scores": T(rng.normal(-2, 2, (2, 3, 30, 10)).astype(np.float32)),
            "dn_bbox_preds": T(rng.normal(0, 1, (2, 3, 30, 10)).astype(np.float32))}
    for p, jp in ((pack, jpack), (None, None)):
        got = joint_head.joint_family_loss(outs, boxes_list, labels_list, dn_pack=p,
                                           pc_range=PC, dn_weight=0.7)
        want = jjoint.joint_family_loss(jtree(outs), boxes_list, labels_list, dn_pack=jp,
                                        pc_range=PC, dn_weight=0.7)
        assert ("loss_dn" in got) == (p is not None)
        assert_terms(got, want)


# --------------------------------------------------------- cascade RoI


def test_cascade_host_functions_match_jax():
    """IoU matrix, MaxIoU assignment at the three stages' thresholds (with
    low-quality positives and no gt), bbox2delta at each stage's stds:
    equal; smooth_l1 within 1e-7."""
    rng = np.random.default_rng(6)
    boxes = np.concatenate([rng.uniform(0, 60, (30, 2)), rng.uniform(0, 60, (30, 2)) + 70], -1)
    gt = np.concatenate([rng.uniform(0, 60, (4, 2)), rng.uniform(0, 60, (4, 2)) + 70], -1)
    np.testing.assert_array_equal(vestigial_train.iou_xyxy_matrix(boxes, gt),
                                  jvestigial.iou_xyxy_matrix(boxes, gt))
    for cfg in vestigial_train.CASCADE_STAGE_CFG:
        thr = (cfg["pos_iou_thr"], cfg["neg_iou_thr"], cfg["min_pos_iou"])
        for g in (gt, gt[:0]):
            np.testing.assert_array_equal(vestigial_train.max_iou_assign(boxes, g, *thr),
                                          jvestigial.max_iou_assign(boxes, g, *thr))
        np.testing.assert_array_equal(
            vestigial_train.bbox2delta(boxes[:4], gt, stds=cfg["stds"]),
            jvestigial.bbox2delta(boxes[:4], gt, stds=cfg["stds"]))
    x = rng.normal(0, 2, 200).astype(np.float32)
    close(vestigial_train.smooth_l1(T(x), 0.5).numpy(), jvestigial.smooth_l1(jnp.asarray(x), 0.5),
          1e-7)


@pytest.mark.parametrize("stds", [None, ((0.2, 0.2, 0.3, 0.3),)])
def test_cascade_train_loss_matches_jax(stds):
    """``cascade_train_loss`` on a drawn CascadeRoIHead's outputs (4 images
    of 12 proposals near 3, 2, 0 and 1 boxes, one proposal invalid), each
    stage against its own input boxes, with the mmdet stds and with the
    head's own: every stage term within 1e-5."""
    rng = np.random.default_rng(7)
    m, p, c = 4, 12, 16
    head = drawn(cascade_roi.CascadeRoIHead(in_channels=c, fc_out_channels=32,
                                            **({"stage_stds": stds} if stds else {})), 8)
    counts = (3, 2, 0, 1)
    gt_boxes, gt_labels, boxes = [], [], np.zeros((m, p, 4), np.float32)
    for i, g in enumerate(counts):
        gb = np.concatenate([rng.uniform(0, 60, (g, 2)), rng.uniform(30, 60, (g, 2))], -1)
        gb[:, 2:] += gb[:, :2]
        gt_boxes.append(gb.astype(np.float32))
        gt_labels.append(rng.integers(0, 10, g))
        src = gb[rng.integers(0, g, p)] if g else np.tile([[10, 10, 40, 40]], (p, 1))
        boxes[i] = src + rng.normal(0, 4, (p, 4))
    valid = np.ones((m, p), np.float32)
    valid[1, 3] = 0.0
    feat = T(rng.standard_normal((m, c, 8, 16)).astype(np.float32))
    outs = head(feat, T(boxes), T(valid))
    kw = {"stage_stds": stds} if stds else {}
    got = cascade_roi.cascade_train_loss(outs, boxes, valid, gt_boxes, gt_labels, 10, **kw)
    want = jcascade.cascade_train_loss(jtree(outs), boxes, valid, gt_boxes, gt_labels, 10, **kw)
    assert_terms(got, want)
    assert float(got["s0.loss_bbox"]) > 0


# ------------------------------------------------------------------ YOLOX


def test_yolox_targets_and_loss_match_jax():
    """``yolox_targets`` on a drawn YOLOX head's outputs (2 images: 3 boxes
    with 2D centres, 1 box without): equal; ``yolox_loss`` with and
    without the L1 term: every term within 1e-5."""
    rng = np.random.default_rng(9)
    sizes, strides = [(8, 16), (4, 8), (2, 4)], (8, 16, 32)
    head = drawn(yolox_head.YOLOXHead(in_channels=16, feat_channels=16), 10)
    with torch.no_grad():
        outs = head([T(rng.standard_normal((2, 16, h, w)).astype(np.float32))
                     for h, w in sizes])
    priors = yolox_head.mlvl_priors(sizes, strides)
    dec = yolox_head.bbox_decode(priors, outs["enc_bbox_preds"]).numpy()
    gt_b = [np.array([[10, 8, 60, 40], [20, 12, 70, 50], [80, 30, 120, 62]], np.float32),
            np.array([[40, 10, 90, 60]], np.float32)]
    gt_l = [np.array([1, 4, 9]), np.array([2])]
    c2d = [np.array([[35, 24], [45, 31], [100, 46]], np.float32), np.zeros((0, 2), np.float32)]
    args = (priors, outs["enc_cls_scores"].numpy(), outs["objectnesses"].numpy(), dec, gt_b,
            gt_l, c2d)
    got = yolox_head.yolox_targets(*args)
    want = jyolox.yolox_targets(*args)
    for a, r in zip(got, want):
        np.testing.assert_array_equal(a, r)
    assert got[-1] > 0
    for use_l1 in (False, True):
        assert_terms(yolox_head.yolox_loss(outs, priors, got, use_l1=use_l1),
                     jyolox.yolox_loss(jtree(outs), priors, want, use_l1=use_l1))


# ------------------------------------------------- the vector-map AP


def polylines(rng, n, pts=8):
    return [np.cumsum(rng.normal(0, 1, (rng.integers(2, pts), 2)), 0) for _ in range(n)]


def test_vector_metrics_match_jax_exactly():
    """chamfer distance, resampling (a single point, a zero-length line),
    AP, the instance match with no gt and no prediction, and the whole
    evaluation over 4 samples of 3 classes: equal."""
    rng = np.random.default_rng(11)
    a, b = rng.normal(0, 1, (30, 2)), rng.normal(0.5, 1, (40, 2))
    assert vector_metrics.chamfer_distance(a, b) == jvector.chamfer_distance(a, b)
    for line in (a[:7], a[:1], np.repeat(a[:1], 3, 0)):
        np.testing.assert_array_equal(vector_metrics.interp_fixed_num(line, 20),
                                      jvector.interp_fixed_num(line, 20))
    rec, prec = np.sort(rng.uniform(0, 1, 12)), rng.uniform(0, 1, 12)
    assert vector_metrics.average_precision(rec, prec) == jvector.average_precision(rec, prec)
    preds = rng.normal(0, 2, (5, 20, 2))
    gts = preds[:3] + rng.normal(0, 0.3, (3, 20, 2))
    scores = rng.uniform(0, 1, 5)
    for g, pr in ((gts, preds), (gts[:0], preds), (gts, preds[:0])):
        for (t, f), (jt, jf) in zip(vector_metrics.instance_match(pr, scores[:len(pr)], g),
                                    jvector.instance_match(pr, scores[:len(pr)], g)):
            np.testing.assert_array_equal(t, jt)
            np.testing.assert_array_equal(f, jf)
    samples_p, samples_g = [], []
    for _ in range(4):
        gt = {c: polylines(rng, int(rng.integers(0, 4))) for c in (0, 1, 2)}
        vecs = [v + rng.normal(0, 0.4, v.shape) for c in gt for v in gt[c]] + polylines(rng, 2)
        labels = [c for c in gt for _ in gt[c]] + [int(rng.integers(0, 3)) for _ in range(2)]
        samples_g.append(gt)
        samples_p.append({"vectors": vecs, "scores": list(rng.uniform(0, 1, len(vecs))),
                          "labels": labels})
    got = vector_metrics.evaluate_vectors(samples_p, samples_g)
    want = jvector.evaluate_vectors(samples_p, samples_g)
    assert got == want and 0 < got["mAP"] <= 1


# ------------------------------------------------------- the eval filters


def test_eval_filters_match_jax_exactly():
    """The visibility tests on 200 random camera-frame points (each level),
    partly visible corners, the token filter, the per-camera counts and the
    overlap subset on 6 cameras around the ego, the corners in a camera's
    frame: equal."""
    rng = np.random.default_rng(12)
    k = np.eye(4)
    k[0, 0] = k[1, 1] = 100.0
    k[0, 2], k[1, 2] = 160.0, 96.0
    imsize = (320, 192)
    for pt in rng.normal(0, 1, (200, 3)) * [10, 6, 8] + [0, 0, 3]:
        for level in ("all", "any", "none"):
            assert (eval_filters.center_in_image(pt, k, imsize, level)
                    == jfilters.center_in_image(pt, k, imsize, level))
    boxes = np.concatenate([rng.uniform(-30, 30, (40, 2)), rng.uniform(-2, 1, (40, 1)),
                            rng.uniform(0.5, 8, (40, 3)), rng.uniform(-3, 3, (40, 1))], -1)
    extr = []
    for ci in range(6):
        yaw = 2 * np.pi * ci / 6
        c, s = np.cos(yaw), np.sin(yaw)
        e = np.eye(4)
        e[:3, :3] = [[-s, c, 0], [0, 0, -1], [c, s, 0]]
        extr.append(e)
    extr, intr = np.stack(extr), np.stack([k] * 6)
    for ci in range(6):
        cc = eval_filters.corners_cam(boxes, extr[ci])
        np.testing.assert_array_equal(cc, jfilters.corners_cam(boxes, extr[ci]))
        for corners in cc:
            assert (eval_filters.exist_corners_in_image_but_not_all(corners, k, imsize)
                    == jfilters.exist_corners_in_image_but_not_all(corners, k, imsize))
    counts = eval_filters.visible_camera_count(boxes, extr, intr, imsize)
    np.testing.assert_array_equal(counts, jfilters.visible_camera_count(boxes, extr, intr,
                                                                        imsize))
    np.testing.assert_array_equal(eval_filters.filter_boxes_by_overlap(boxes, extr, intr, imsize),
                                  jfilters.filter_boxes_by_overlap(boxes, extr, intr, imsize))
    vis = [str(v) for v in rng.integers(1, 5, 40)]
    np.testing.assert_array_equal(eval_filters.filter_boxes_by_visibility(boxes, vis, "2"),
                                  jfilters.filter_boxes_by_visibility(boxes, vis, "2"))
    assert counts.max() >= 1
