"""The port's YOLOX 2D head (the priors, the decoders, the head and SimOTA)
against the JAX package's, on the CPU.

The head's parameters are drawn on the port's side
(``test_torch_perception_zoo.drawn``: batch-norm scales and variances in
[0.5, 1.5]) and carried to the JAX head through ``convert.yolox_head_map``
walked backwards (``torch_parity.to_jax``). Tolerances, stated per test:
the head and the decoders within 1e-5 of each output's largest value
(fp32 on both sides); the host's priors and SimOTA assignment exactly
equal. Torch and BLAS run on two threads.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_perception import close
from test_torch_perception_train import T
from test_torch_perception_zoo import drawn
from torch_parity import to_jax, two_threads  # noqa: F401

from panacea_tpu.perception import yolox_head as jyolox
from panacea_tpu_torch import convert
from panacea_tpu_torch.perception import yolox_head

pytestmark = pytest.mark.usefixtures("two_threads")
SIZES, STRIDES = [(8, 16), (4, 8), (2, 4)], (8, 16, 32)


def head_and_outputs(rng, b=2, c=16):
    """The port head (feat_channels 24) and the JAX head's outputs on the
    same 3 levels of a 64 x 128 image."""
    head = drawn(yolox_head.YOLOXHead(in_channels=c, feat_channels=24), 1)
    params = to_jax(head, convert.yolox_head_map("n", ()))
    feats = [rng.standard_normal((b, h, w, c)).astype(np.float32) for h, w in SIZES]
    want = jax.jit(lambda prm, fs: jyolox.YOLOXHead(in_channels=c, feat_channels=24).apply(
        {"params": prm}, fs))(params, [jnp.asarray(f) for f in feats])
    with torch.no_grad():
        got = head([T(f).permute(0, 3, 1, 2) for f in feats])
    return got, want


def test_yolox_head_and_decoders_match_jax():
    """The head (2 convs a tower, 3 levels, BN eps 1e-3 and Swish): the four
    flattened outputs within 1e-5; the priors equal; ``bbox_decode`` and
    ``centers2d_decode`` on the head's outputs within 1e-5."""
    got, want = head_and_outputs(np.random.default_rng(0))
    for k in ("enc_cls_scores", "enc_bbox_preds", "objectnesses", "pred_centers2d_offset"):
        close(got[k].numpy(), want[k], 1e-5)
    assert got["enc_cls_scores"].shape == (2, 128 + 32 + 8, 10) and got["topk_indexes"] is None
    priors = yolox_head.mlvl_priors(SIZES, STRIDES)
    np.testing.assert_array_equal(priors, jyolox.mlvl_priors(SIZES, STRIDES))
    close(yolox_head.bbox_decode(priors, got["enc_bbox_preds"]).numpy(),
          jyolox.bbox_decode(priors, want["enc_bbox_preds"]), 1e-5)
    close(yolox_head.centers2d_decode(priors, got["pred_centers2d_offset"]).numpy(),
          jyolox.centers2d_decode(priors, want["pred_centers2d_offset"]), 1e-5)


def test_simota_assign_matches_jax():
    """SimOTA on the JAX head's host copies, per image: 3 boxes (two
    overlapping), 1 box, none, and one box no prior's centre reaches: the
    assignment and the IoUs exactly equal."""
    rng = np.random.default_rng(1)
    _, want = head_and_outputs(rng, b=2)
    priors = jyolox.mlvl_priors(SIZES, STRIDES)
    cls = np.asarray(want["enc_cls_scores"])
    obj = np.asarray(want["objectnesses"])
    dec = np.asarray(jyolox.bbox_decode(priors, want["enc_bbox_preds"]))
    cases = [(np.array([[10, 8, 60, 40], [20, 12, 70, 50], [80, 30, 120, 62]], np.float32),
              np.array([1, 4, 9])),
             (np.array([[40, 10, 90, 60]], np.float32), np.array([2])),
             (np.zeros((0, 4), np.float32), np.zeros((0,), np.int64)),
             (np.array([[1000, 1000, 1010, 1010]], np.float32), np.array([0]))]
    positives = 0
    for bi, (gb, gl) in enumerate(cases):
        i = bi % 2
        got = yolox_head.simota_assign(cls[i], obj[i], priors, dec[i], gb, gl)
        ref = jyolox.simota_assign(cls[i], obj[i], priors, dec[i], gb, gl)
        for a, r in zip(got, ref):
            np.testing.assert_array_equal(a, r)
        positives += int((got[0] >= 0).sum())
    assert positives > 0
