"""The port's proposal-query heads (SparseHeadv3/v4) and the DETR3D
family's loss (``sparse_v4_loss``) against the JAX package's, on the CPU.

Every parameter is drawn on the port's side (``test_torch_perception_zoo.
drawn``) and carried to the JAX modules by the JAX package's own
``convert_streampetr_checkpoint``. Inputs and ground truth are numpy
arrays from a seed; the DN noise is the JAX draw, handed to the port. The
host's Hungarian matchings run on the same detached numbers in both
packages, so both losses use the same assignment (the test checks it).
Tolerances, stated per test: the heads within 1e-4 of each output's
largest value (the perception tests' tolerance: deformable sampling and
the decoder layers in another order of summation), the losses within
1e-5. Torch and BLAS run on two threads.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_perception import close, torch_tree
from test_torch_perception_train import PC, T, dn_noise, gt_batch
from test_torch_perception_zoo import TINY, drawn, head_inputs, port_feats
from torch_parity import two_threads  # noqa: F401

from panacea_tpu.perception import denoise as jdenoise
from panacea_tpu.perception import sparse_head_v3 as jv3
from panacea_tpu.perception import vestigial_train as jvestigial
from panacea_tpu.perception.head import init_memory as jinit_memory
from panacea_tpu.utils.convert import convert_streampetr_checkpoint
from panacea_tpu_torch.perception import denoise, detector, sparse_head_v3, train, vestigial_train
from panacea_tpu_torch.perception.head import init_memory

pytestmark = pytest.mark.usefixtures("two_threads")
EVA = dict(width=64, heads=4, layers=3, window_size=4, window_block_indexes=(0, 2),
           residual_block_indexes=(1,))
EVA_MAP = dict(depth=3, residual_block_indexes=(1,))


def to_jax_detector(sd, backbone="r50", head="sparse_v3"):
    """The JAX tree of a port state dict through the JAX converter, none of
    its names unexpected; EVA's position table (the port's, already at the
    working grid) set in the tree as the JAX module holds it."""
    sd = dict(sd)
    pos = sd.pop("img_backbone.pos_embed", None)
    params, report = convert_streampetr_checkpoint(
        {k: v.numpy() for k, v in sd.items()}, num_layers=2, stage_blocks=(1, 1, 1, 1),
        backbone=backbone, head=head, eva_cfg=EVA_MAP if backbone == "eva" else None)
    assert report["unexpected"] == [], report["unexpected"][:5]
    if pos is not None:
        params["backbone"]["pos_embed"] = pos.numpy()
    return params


def proposals(rng, b, p, c):
    return {"proposal_positions": rng.uniform(-40, 40, (b, p, 3)).astype(np.float32),
            "proposal_features": rng.standard_normal((b, p, 2 * c)).astype(np.float32)}


# ----------------------------------------------------------- the heads


@pytest.mark.parametrize("mode, with_proposals", [("context", True), ("seed", True),
                                                  ("context", False), ("seed", False)])
def test_sparse_head_proposal_matches_jax(mode, with_proposals):
    """The tiny head (2 layers, 12 queries, 8 propagated) on 2 levels of 2
    cameras over 2 frames: v3's P = 6 proposal queries with projected
    content, v4's proposals seeding the learned points, or without
    proposals SparseHead's learned queries; with proposals each frame also
    with a DN pack sized for the proposal count (v3 6, v4 12 match
    queries). Outputs and memory within 1e-4."""
    rng = np.random.default_rng(20)
    b, n, h, w, c, p = 2, 2, 32, 64, 32, 6
    cfg = dict(TINY, num_levels=2, num_cams=n)
    data, feats = head_inputs(rng, b, n, h, w, c, 2, levels=(8, 16))
    if with_proposals:
        for k, v in proposals(rng, b, p, c).items():
            data[k] = np.repeat(v[:, None], 2, 1)
    head = drawn(sparse_head_v3.SparseHeadProposal(mode=mode, **cfg), 21)
    params = to_jax_detector({f"pts_bbox_head.{k}": v for k, v in head.state_dict().items()})
    jhead = jv3.SparseHeadProposal(mode=mode, **cfg)
    nq = head.query_count(p if with_proposals else None)
    assert nq == {"context": p, "seed": 12}[mode] if with_proposals else nq == 12
    boxes, labels = gt_batch(rng, b, 3, [3, 1])
    key = jax.random.PRNGKey(22)
    jpack = jdenoise.prepare_dn(key, jnp.asarray(boxes), jnp.asarray(labels), num_query=nq,
                                num_propagated=8, memory_len=24, pc_range=PC, scalar=10)
    pack = denoise.prepare_dn(T(boxes), T(labels), num_query=nq, num_propagated=8, memory_len=24,
                              pc_range=PC, scalar=10, rand_prob=T(dn_noise(key, b, 30).copy()))
    jpack, pack = (jpack, pack) if with_proposals else (None, None)
    run = jax.jit(lambda prm, f, m, d: jhead.apply({"params": prm}, f, m, d, (h, w), dn=jpack))
    jmem, mem = jinit_memory(b, 24, c), init_memory(b, 24, c)
    for fi in range(2):
        d = {k: v[:, fi] for k, v in data.items()}
        jouts, jmem = run(params["head"], [jnp.asarray(f) for f in feats[fi]], jmem,
                          {k: jnp.asarray(v) for k, v in d.items()})
        with torch.no_grad():
            outs, mem = head(port_feats(feats[fi]), mem, torch_tree(d), (h, w), dn=pack)
        assert outs.keys() == jouts.keys()
        assert outs["all_cls_scores"].shape == (2, b, nq + 8, 10)
        for k in jouts:
            close(outs[k].numpy(), jouts[k], 1e-4)
        for field in jmem._fields:
            close(getattr(mem, field).numpy(), getattr(jmem, field), 1e-4)


def test_dn_pack_of_the_wrong_size_raises_in_both_packages():
    """A DN pack built for num_query 12 against v3's 6 proposal queries: the
    same ValueError in both packages; and the trainer sizes the pack from
    the proposals (v3 P, v4 max(P, num_query))."""
    rng = np.random.default_rng(23)
    b, n, h, w, c, p = 1, 2, 32, 64, 32, 6
    cfg = dict(TINY, num_levels=1, num_cams=n)
    data, feats = head_inputs(rng, b, n, h, w, c, 1)
    data.update({k: v[:, None] for k, v in proposals(rng, b, p, c).items()})
    d0 = {k: v[:, 0] for k, v in data.items()}
    boxes, labels = gt_batch(rng, b, 2, [2])
    key = jax.random.PRNGKey(24)
    jpack = jdenoise.prepare_dn(key, jnp.asarray(boxes), jnp.asarray(labels), num_query=12,
                                num_propagated=8, memory_len=24, pc_range=PC, scalar=10)
    pack = denoise.prepare_dn(T(boxes), T(labels), num_query=12, num_propagated=8, memory_len=24,
                              pc_range=PC, scalar=10, rand_prob=T(dn_noise(key, b, 20).copy()))
    head = drawn(sparse_head_v3.SparseHeadv3(**cfg), 25)
    params = to_jax_detector({f"pts_bbox_head.{k}": v for k, v in head.state_dict().items()})
    with pytest.raises(ValueError, match="DN attention mask sized for 12 queries but the "
                                         "proposal path produced 6"):
        jv3.SparseHeadv3(**cfg).apply({"params": params["head"]},
                                      [jnp.asarray(f) for f in feats[0]], jinit_memory(b, 24, c),
                                      {k: jnp.asarray(v) for k, v in d0.items()}, (h, w),
                                      dn=jpack)
    with pytest.raises(ValueError, match="DN attention mask sized for 12 queries but the "
                                         "proposal path produced 6"):
        head(port_feats(feats[0]), init_memory(b, 24, c), torch_tree(d0), (h, w), dn=pack)
    model = detector.Sparse4Dv3(backbone_cfg={"stage_blocks": (1, 1, 1, 1)}, **TINY)
    sizes = []
    for head_type, want in (("sparse_v3", p), ("sparse_v4", 12)):
        model.pts_bbox_head = sparse_head_v3.SparseHeadProposal(
            mode={"sparse_v3": "context", "sparse_v4": "seed"}[head_type], **TINY)
        model.train_frame = lambda imgs, memory, data, dn: sizes.append(dn.attn_mask.shape) or (
            None, None, memory)
        trainer = train.DetectorTrainer(PC, use_grid_mask=False, streaming=True)
        draws = trainer.draw(torch.Generator().manual_seed(0), 32, b, 2)
        trainer.forward(model, torch.zeros(b, 6, 32, 64, 3), torch_tree(d0), T(boxes),
                        T(labels), draws, init_memory(b, 24, c))
        assert sizes[-1] == (20 + want + 8, 20 + want + 24)


def detr3d_inputs(rng, layers=2, b=3, q=20):
    cls = rng.normal(-2, 2, (layers, b, q, 10)).astype(np.float32)
    reg = rng.normal(0, 2, (layers, b, q, 10)).astype(np.float32)
    boxes, labels = gt_batch(rng, b, 4, [4, 0, 2])
    boxes_list = [boxes[i, :g] for i, g in enumerate((4, 0, 2))]
    labels_list = [labels[i, :g] for i, g in enumerate((4, 0, 2))]
    boxes_list[2][1, 7] = np.nan          # a box with no velocity
    return cls, reg, boxes_list, labels_list


def test_detr3d_family_and_sparse_v4_losses_match_jax():
    """Two layers over three images (4, 0 and 2 boxes, one with a nan
    velocity): each layer's targets equal JAX's (the same assignment), and
    every loss term within 1e-5, with and without SimMOD's pinned
    queries; ``sparse_v4_loss`` on a head's outputs too."""
    rng = np.random.default_rng(30)
    cls, reg, boxes_list, labels_list = detr3d_inputs(rng)
    for li in range(2):
        got = vestigial_train.detr3d_layer_targets(cls[li], reg[li], boxes_list, labels_list, 10)
        want = jvestigial.detr3d_layer_targets(cls[li], reg[li], boxes_list, labels_list, 10)
        for a, j in zip(got, want):
            np.testing.assert_array_equal(a, j)
    pins = [np.array([3] + [-1] * 19), np.full(20, -1), np.array([-1, 0, 0] + [-1] * 17)]
    for pre in (None, pins):
        got = vestigial_train.detr3d_family_loss(T(cls), T(reg), boxes_list, labels_list,
                                                 pre_assigns_list=pre)
        want = jvestigial.detr3d_family_loss(jnp.asarray(cls), jnp.asarray(reg), boxes_list,
                                             labels_list, pre_assigns_list=pre)
        assert got.keys() == want.keys() == {"loss", "loss_cls", "loss_bbox", "d0.loss_cls",
                                             "d0.loss_bbox"}
        for k in want:
            close(got[k].numpy(), want[k], 1e-5)
    outs = {"all_cls_scores": T(cls), "all_bbox_preds": T(reg)}
    got = sparse_head_v3.sparse_v4_loss(outs, boxes_list, labels_list, bg_cls_weight=0.1)
    want = jv3.sparse_v4_loss({k: jnp.asarray(v.numpy()) for k, v in outs.items()}, boxes_list,
                              labels_list, bg_cls_weight=0.1)
    for k in want:
        close(got[k].numpy(), want[k], 1e-5)
