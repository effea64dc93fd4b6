"""The port's motion-forecasting metrics (``perception/motion_metrics.py``)
against the JAX package's, on seeded predictions: every public function
within 1e-9 relative (both are float64 NumPy), the indices equal; futures
of ragged length, empty ones included, and the trajectory-gated matching.
"""

import numpy as np
import pytest

from panacea_tpu.perception import motion_metrics as jmm
from panacea_tpu_torch.perception import motion_metrics as mm
from panacea_tpu_torch.perception.metrics import CLASS_NAMES

RTOL = 1e-9


def ragged(rng, b, s):
    """(B, S) invalid-step masks (1 = invalid) of ragged length, one row
    with no valid step and one with all."""
    lengths = rng.integers(0, s + 1, b)
    lengths[0], lengths[-1] = 0, s
    return (np.arange(s)[None] >= lengths[:, None]).astype(np.float64)


def test_displacement_errors_match_jax():
    rng = np.random.default_rng(0)
    b, m, s = 9, 6, 12
    traj = rng.normal(0, 3, (b, m, s, 2))
    gt = rng.normal(0, 3, (b, s, 2))
    masks = ragged(rng, b, s)
    for name in ("min_ade", "min_fde"):
        err, idx = getattr(mm, name)(traj, gt, masks)
        jerr, jidx = getattr(jmm, name)(traj, gt, masks)
        np.testing.assert_allclose(err, jerr, rtol=RTOL)
        np.testing.assert_array_equal(idx, jidx)
    for th in (0.5, 2.0, 6.0):
        assert mm.miss_rate(traj, gt, masks, th) == pytest.approx(
            jmm.miss_rate(traj, gt, masks, th), rel=RTOL)


@pytest.mark.parametrize("valid", [0, 1, 5, 12, 15])
def test_per_match_metrics_match_jax(valid):
    """``prediction_metrics`` and ``traj_fde`` of one match, a future of
    ``valid`` steps (0: an empty future; 15: longer than the prediction)."""
    rng = np.random.default_rng(valid + 1)
    gt, pred = rng.normal(0, 4, (valid, 2)), rng.normal(0, 4, (6, 12, 2))
    np.testing.assert_allclose(mm.prediction_metrics(gt, pred),
                               jmm.prediction_metrics(gt, pred), rtol=RTOL)
    for final in (6, 12):
        got, want = mm.traj_fde(gt, pred, final), jmm.traj_fde(gt, pred, final)
        assert got == want if np.isinf(want) else got == pytest.approx(want, rel=RTOL)


def scene(seed, n_samples=6):
    """Seeded predictions and ground truths: boxes near the ground truth's
    (some far, some of another class), scores, futures of ragged length
    (some empty) and predicted modes near them or far off, so that the
    trajectory gate rejects some distance matches."""
    rng = np.random.default_rng(seed)
    preds, gts = [], []
    for _ in range(n_samples):
        g = int(rng.integers(0, 7))
        boxes = np.zeros((g, 9))
        boxes[:, :2] = rng.uniform(-40, 40, (g, 2))
        boxes[:, 3:6] = rng.uniform(0.5, 4, (g, 3))
        labels = rng.integers(0, 4, g)
        trajs = [boxes[i, :2] + np.cumsum(rng.normal(0, 1, (int(rng.integers(0, 13)), 2)), 0)
                 for i in range(g)]
        gts.append({"boxes": boxes, "labels": labels, "trajs": trajs})
        k = g + int(rng.integers(0, 4))
        pb = np.zeros((k, 9))
        pl = rng.integers(0, 4, k)
        pt = rng.normal(0, 20, (k, 6, 12, 2))
        pb[:, :2] = rng.uniform(-40, 40, (k, 2))
        pb[:, 3:6] = rng.uniform(0.5, 4, (k, 3))
        for i in range(g):
            pb[i, :2] = boxes[i, :2] + rng.normal(0, 0.6, 2)
            pl[i] = labels[i] if rng.random() < 0.8 else pl[i]
            fut = np.zeros((12, 2))
            fut[:len(trajs[i])] = trajs[i][:12]
            pt[i] = fut[None] + rng.normal(0, 0.3 if rng.random() < 0.6 else 4.0, (6, 12, 2))
        preds.append({"boxes": pb, "labels": pl, "scores": rng.uniform(0.05, 1, k),
                      "trajs": pt})
    return preds, gts


def same(got, want):
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            same(got[k], want[k])
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            same(a, b)
    elif isinstance(want, (int, np.integer)):
        assert got == want
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_accumulation_and_evaluation_match_jax(seed):
    """``accumulate_class_motion`` (gated at 1 m and 2 m, plain, with the
    ungated counts beside) for every class, and ``evaluate_motion`` with
    EPA: every number within 1e-9 relative, every count equal; the gate
    removes matches."""
    preds, gts = scene(seed)
    gated = plain = 0
    for cname in CLASS_NAMES:
        for kw in (dict(dist_th=1.0), dict(dist_th=2.0, also_ungated=True),
                   dict(dist_th=2.0, gate_on_traj=False)):
            got = mm.accumulate_class_motion(preds, gts, cname, **kw)
            same(got, jmm.accumulate_class_motion(preds, gts, cname, **kw))
            if kw.get("also_ungated"):
                gated, plain = gated + got[2], plain + got[5]
    assert 0 < gated < plain
    same(mm.evaluate_motion(preds, gts), jmm.evaluate_motion(preds, gts))
    with pytest.raises(ValueError, match="prep was built"):
        mm.accumulate_class_motion(preds, gts, "truck", 1.0,
                                   prep=mm._prep_class_motion(preds, gts, "car", 12))
