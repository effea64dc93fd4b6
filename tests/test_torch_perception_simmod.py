"""The port's SimMOD (the two-stage projective attention, the FCOS proposal
head and the SimMOD head and driver) against the JAX package's, on the CPU.

Every parameter is drawn on the port's side (``test_torch_perception_zoo.
drawn``) and carried to the JAX modules through the port's ``convert``
maps walked backwards (``torch_parity.to_jax``). Inputs are numpy arrays
from a seed. Tolerances, stated per test: the sampling, the heads and the
driver within 1e-4 of each output's largest value (the perception tests'
tolerance: fp32 on both sides in another order of summation); the
proposal indices, views and levels equal. Torch and BLAS run on two
threads.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_perception import calib, close, torch_tree
from test_torch_perception_train import PC, T
from test_torch_perception_zoo import drawn, port_feats
from torch_parity import assert_same_state, to_jax, two_threads  # noqa: F401

from panacea_tpu.perception import simmod as jsimmod
from panacea_tpu.perception import twostage_attn as jtwostage
from panacea_tpu.perception.fcos_proposal import FCOSProposalHead as JFCOSProposalHead
from panacea_tpu.perception.resnet import ResNet50 as JResNet50
from panacea_tpu_torch import convert
from panacea_tpu_torch.perception import simmod, twostage_attn
from panacea_tpu_torch.perception.fcos_proposal import FCOSProposalHead

pytestmark = pytest.mark.usefixtures("two_threads")
FCOS_TINY = dict(stacked_convs=1, cls_branch=(16,))


def l2i_data(rng, b, n, h, w):
    l2i, intr, extr = calib(rng, b, n, h, w)
    return {"lidar2img": l2i, "intrinsics": intr, "extrinsics": extr}


def fcos_scales(head, prefix):
    """The JAX head's packed (L, 2) scales of the port head's Scale modules,
    and the reference names that ``convert.fcos_scales_from_jax`` gives
    them back under (``prefix``), each equal to the port's."""
    scales = np.array([[s["offset"].scale.item(), s["depth"].scale.item()] for s in head.scales],
                      np.float32)
    names = convert.fcos_scales_from_jax(scales, prefix)
    sd = head.state_dict()
    assert all(float(v) == float(sd[k[len(prefix) + 1:]]) for k, v in names.items())
    return scales, names


# ---------------------------------------------------- the two-stage attention


def test_bilinear_sample_and_projection_match_jax():
    """``bilinear_sample_ac`` (grid_sample, align_corners=True) against the
    JAX gather, points inside, on the border and outside the map; then
    ``project_reference_points`` with the image and with valid ranges:
    xy within 1e-5, the masks equal."""
    rng = np.random.default_rng(0)
    feat = rng.standard_normal((3, 7, 9, 5)).astype(np.float32)
    grid = rng.uniform(-1.3, 1.3, (3, 40, 2)).astype(np.float32)
    grid[:, :4] = [[-1, -1], [1, 1], [1, -1], [-1.0, 0.25]]
    want = jtwostage.bilinear_sample_ac(jnp.asarray(feat), jnp.asarray(grid))
    got = twostage_attn.bilinear_sample_ac(T(feat).permute(0, 3, 1, 2), T(grid))
    close(got.numpy(), want, 1e-5)

    b, n, q, h, w = 2, 3, 50, 96, 160
    d = l2i_data(rng, b, n, h, w)
    ref = rng.uniform(0, 1, (b, q, 3)).astype(np.float32)
    vr = np.tile(np.array([10.0, 5.0, 140.0, 90.0], np.float32), (b, n, 1))
    for valid in (None, vr):
        jxy, jmask = jtwostage.project_reference_points(
            jnp.asarray(ref), jnp.asarray(d["lidar2img"]), PC, (h, w),
            None if valid is None else jnp.asarray(valid))
        xy, mask = twostage_attn.project_reference_points(
            T(ref), T(d["lidar2img"]), PC, (h, w), None if valid is None else T(valid))
        close(xy.numpy(), jxy, 1e-5)
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
        assert 0 < float(mask.sum()) < mask.numel()


@pytest.mark.parametrize("depth_wise, pos_linear", [(False, False), (True, False),
                                                    (False, True)])
def test_twostage_cross_atten_matches_jax(depth_wise, pos_linear):
    """TwoStageDetr3DCrossAtten on 3 cameras, 2 levels, 30 queries, both
    weight layouts and the linear position encoder: within 1e-4."""
    rng = np.random.default_rng(1)
    b, n, q, c, h, w = 2, 3, 30, 32, 64, 128
    kw = dict(embed_dims=c, num_levels=2, num_points=3, num_cams=n, pc_range=PC,
              depth_wise_weights=depth_wise, pos_encoder_linear=pos_linear)
    mod = drawn(twostage_attn.TwoStageDetr3DCrossAtten(**kw), 2)
    params = to_jax(mod, convert.twostage_attn_map("n", (), pos_linear))
    feats = [rng.standard_normal((b, n, h // s, w // s, c)).astype(np.float32) for s in (8, 16)]
    query, qpos = (rng.standard_normal((b, q, c)).astype(np.float32) for _ in range(2))
    ref = rng.uniform(0, 1, (b, q, 3)).astype(np.float32)
    d = l2i_data(rng, b, n, h, w)
    want = jax.jit(lambda prm, *a: jtwostage.TwoStageDetr3DCrossAtten(**kw).apply(
        {"params": prm}, *a[:4], (h, w), query_pos=a[4]))(
        params, jnp.asarray(query), [jnp.asarray(f) for f in feats], jnp.asarray(ref),
        jnp.asarray(d["lidar2img"]), jnp.asarray(qpos))
    with torch.no_grad():
        got = mod(T(query), port_feats(feats), T(ref), T(d["lidar2img"]), (h, w),
                  query_pos=T(qpos))
    close(got.numpy(), want, 1e-4)


def test_attention_weights_normalize_is_a_no_op_in_jax_and_refused_by_the_port():
    """The JAX module holds ``attention_weights_normalize`` and never reads
    it (ROADMAP Queue C): its output with the flag equals the output
    without. The port refuses the flag rather than copy the no-op."""
    rng = np.random.default_rng(3)
    b, n, q, c = 1, 2, 5, 16
    mod = drawn(twostage_attn.TwoStageDetr3DCrossAtten(c, num_levels=1, num_cams=n), 4)
    params = to_jax(mod, convert.twostage_attn_map("n", ()))
    args = (jnp.asarray(rng.standard_normal((b, q, c)), jnp.float32),
            [jnp.asarray(rng.standard_normal((b, n, 8, 8, c)), jnp.float32)],
            jnp.asarray(rng.uniform(0, 1, (b, q, 3)), jnp.float32),
            jnp.asarray(l2i_data(rng, b, n, 64, 64)["lidar2img"]), (64, 64))
    outs = [jtwostage.TwoStageDetr3DCrossAtten(c, num_levels=1, num_cams=n,
                                               attention_weights_normalize=flag).apply(
        {"params": params}, *args) for flag in (False, True)]
    np.testing.assert_array_equal(np.asarray(outs[0]), np.asarray(outs[1]))
    with pytest.raises(NotImplementedError, match="attention_weights_normalize"):
        twostage_attn.TwoStageDetr3DCrossAtten(c, attention_weights_normalize=True)


# ------------------------------------------------------- the FCOS proposals


def test_fcos_proposal_head_and_proposals_match_jax():
    """The FCOS head (one stacked conv, the default regression branches) on
    2 levels of 2 images of 3 cameras: every output within 1e-4; then 200
    proposals of 480 tokens a sample, more than the local maxima, so the
    top-k also picks among the pool's exact zeros: indices (the proposals'
    views, levels and features) equal, positions and scores within 1e-4."""
    rng = np.random.default_rng(5)
    b, n, c, h, w = 2, 3, 32, 64, 128
    kw = dict(in_channels=c, feat_channels=c, strides=(8, 16), num_proposal=200, **FCOS_TINY)
    head = drawn(FCOSProposalHead(**kw), 6)
    scales, names = fcos_scales(head, "n")
    params = to_jax(head, convert.fcos_proposal_map("n", (), **FCOS_TINY), carried=names)
    params["scales"] = scales
    feats = [rng.standard_normal((b * n, h // s, w // s, c)).astype(np.float32) for s in (8, 16)]
    d = l2i_data(rng, b, n, h, w)
    jhead = JFCOSProposalHead(**kw)

    def run(prm, fs, dd):
        outs = jhead.apply({"params": prm}, fs)
        return outs, jhead.apply({"params": prm}, outs, dd, n, method=jhead.get_proposals)

    jouts, jprops = jax.jit(run)(params, [jnp.asarray(f) for f in feats],
                                 {k: jnp.asarray(v) for k, v in d.items()})
    with torch.no_grad():
        outs = head([T(f).permute(0, 3, 1, 2) for f in feats])
        props = head.get_proposals(outs, torch_tree(d), n)
    for lo, jlo in zip(outs, jouts):
        assert lo.keys() == jlo.keys()
        for k in jlo:
            close(lo[k].permute(0, 2, 3, 1).numpy(), jlo[k], 1e-4)
    zeros = int((props["proposal_scores"] == 0).sum())
    assert zeros > 0, "the top-k should reach the pool's zeros"
    np.testing.assert_array_equal(props["proposal_positions"][..., 3:].numpy(),
                                  np.asarray(jprops["proposal_positions"][..., 3:]))
    close(props["proposal_features"].numpy(), jprops["proposal_features"], 1e-4)
    close(props["proposal_positions"][..., :3].numpy(), jprops["proposal_positions"][..., :3],
          1e-4)
    close(props["proposal_scores"].numpy(), jprops["proposal_scores"], 1e-4)


# ------------------------------------------------------------ SimMOD


def proposal_inputs(rng, b, n, p, c):
    pos = np.concatenate([rng.uniform(-40, 40, (b, p, 2)), rng.uniform(-4, 2, (b, p, 1)),
                          rng.integers(0, n, (b, p, 1)), rng.integers(0, 2, (b, p, 1))],
                         -1).astype(np.float32)
    return (rng.standard_normal((b, p, 2 * c)).astype(np.float32), pos,
            rng.uniform(0.05, 0.95, (b, p)).astype(np.float32))


@pytest.mark.parametrize("cross_attn, refine, embeds, layers", [
    ("deformable", True, True, 2), ("twostage", True, False, 2), ("deformable", False, False, 1)])
def test_simmod_head_matches_jax(cross_attn, refine, embeds, layers):
    """SimMODHead over 10 proposals on 2 levels of 3 cameras, with the
    deformable or the two-stage cross-attention, with box refinement (2
    layers) and without (the branches shared; 1 layer, the JAX head's only
    depth without it, see the next test), with the proposal camera and
    level embeddings: scores, boxes and the combined scores within 1e-4."""
    rng = np.random.default_rng(7)
    b, n, p, c, h, w = 2, 3, 10, 32, 64, 128
    kw = dict(embed_dims=c, num_decoder_layers=layers, num_levels=2, num_cams=n, pc_range=PC,
              cross_attn=cross_attn, with_box_refine=refine, proposal_cam_embeddings=embeds,
              proposal_level_embeddings=embeds)
    head = drawn(simmod.SimMODHead(**kw), 8)
    params = to_jax(head, convert.simmod_head_map(
        "n", (), layers, cross_attn=cross_attn, with_box_refine=refine,
        proposal_cam_embeddings=embeds, proposal_level_embeddings=embeds),
        packed=convert.simmod_packed("n", (), layers))
    feats = [rng.standard_normal((b, n, h // s, w // s, c)).astype(np.float32) for s in (8, 16)]
    pf, pp, ps = proposal_inputs(rng, b, n, p, c)
    d = l2i_data(rng, b, n, h, w)
    want = jax.jit(lambda prm, fs, *a: jsimmod.SimMODHead(**kw).apply(
        {"params": prm}, fs, *a[:3], (h, w), proposal_scores=a[3]))(
        params, [jnp.asarray(f) for f in feats], jnp.asarray(pf), jnp.asarray(pp),
        {k: jnp.asarray(v) for k, v in d.items()}, jnp.asarray(ps))
    with torch.no_grad():
        got = head(port_feats(feats), T(pf), T(pp), torch_tree(d), (h, w),
                   proposal_scores=T(ps))
    assert got["all_cls_scores"].shape == (layers, b, p, 10)
    for k in ("all_cls_scores", "all_bbox_preds", "all_cls_scores_combined"):
        close(got[k].numpy(), want[k], 1e-4)


def test_simmod_head_without_box_refine_fails_in_jax_past_one_layer():
    """The JAX SimMODHead names its shared branches once per layer in one
    compact scope, so with_box_refine=False and 2 layers raises flax's
    NameInUseError (ROADMAP Queue C); the port's shares one pair of
    branches over the layers, as the reference does."""
    import flax

    b, n, p, c = 1, 2, 4, 16
    kw = dict(embed_dims=c, num_decoder_layers=2, num_levels=1, num_cams=n,
              with_box_refine=False)
    rng = np.random.default_rng(11)
    pf, pp, _ = proposal_inputs(rng, b, n, p, c)
    feats = [jnp.ones((b, n, 4, 8, c))]
    data = {k: jnp.asarray(v) for k, v in l2i_data(rng, b, n, 32, 64).items()}
    with pytest.raises(flax.errors.NameInUseError, match="cls_branch_fc0"):
        jax.eval_shape(lambda: jsimmod.SimMODHead(**kw).init(
            jax.random.PRNGKey(0), feats, jnp.asarray(pf), jnp.asarray(pp), data, (32, 64)))
    head = simmod.SimMODHead(**kw)
    assert len(head.cls_branches) == len(head.reg_branches) == 1
    with torch.no_grad():
        outs = head([torch.ones(b * n, c, 4, 8)], T(pf), T(pp), torch_tree(
            {k: np.asarray(v) for k, v in data.items()}), (32, 64))
    assert outs["all_cls_scores"].shape == (2, b, p, 10)


def test_simmod_driver_matches_jax(monkeypatch):
    """The SimMOD driver (ResNet-50 with one block a stage, the FPN from C3
    with 3 levels, FCOS, the head) on one sample of 2 cameras at 64 x 128
    with 24 proposals: the proposals (indices equal, the rest within 1e-4)
    and every decoder output within 1e-4 of the JAX SimMOD's, whose
    ResNet-50 takes the same blocks."""
    monkeypatch.setattr(jsimmod, "ResNet50", functools.partial(JResNet50,
                                                               stage_blocks=(1, 1, 1, 1)))
    rng = np.random.default_rng(9)
    b, n, h, w = 1, 2, 64, 128
    kw = dict(embed_dims=32, num_levels=3, num_cams=n, num_proposal=24, num_decoder_layers=2,
              fcos_cfg=FCOS_TINY, pc_range=PC)
    model = drawn(simmod.SimMOD(backbone_cfg={"stage_blocks": (1, 1, 1, 1)}, **kw), 10)
    scales, names = fcos_scales(model.img_rpn_head, "img_rpn_head")
    params = to_jax(model, convert.simmod_map(2, stage_blocks=(1, 1, 1, 1), num_levels=3,
                                              fcos_cfg=FCOS_TINY), prefix="",
                    packed=convert.simmod_packed("pts_bbox_head", ("pts_bbox_head",), 2),
                    carried=names)
    params["img_roi_head"]["scales"] = scales
    # and back: the forward entry gives the port's state dict
    assert_same_state(convert.simmod_state_dict_from_jax(
        params, 2, stage_blocks=(1, 1, 1, 1), num_levels=3, fcos_cfg=FCOS_TINY), model)
    imgs = rng.standard_normal((b, n, h, w, 3)).astype(np.float32)
    d = l2i_data(rng, b, n, h, w)
    jouts, jprops = jax.jit(lambda prm, x, dd: jsimmod.SimMOD(**kw).apply(
        {"params": prm}, x, dd))(params, jnp.asarray(imgs), {k: jnp.asarray(v)
                                                            for k, v in d.items()})
    with torch.no_grad():
        outs, props = model(T(imgs), torch_tree(d))
    np.testing.assert_array_equal(props["proposal_positions"][..., 3:].numpy(),
                                  np.asarray(jprops["proposal_positions"][..., 3:]))
    for k in ("proposal_features", "proposal_scores"):
        close(props[k].numpy(), jprops[k], 1e-4)
    for k in ("all_cls_scores", "all_bbox_preds", "all_cls_scores_combined"):
        close(outs[k].numpy(), jouts[k], 1e-4)
