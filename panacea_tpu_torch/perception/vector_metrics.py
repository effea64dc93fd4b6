"""Vector-map AP: chamfer-matched instance AP over polyline classes.

Counterpart of ``panacea_tpu/perception/vector_metrics.py``, a NumPy copy
(the generation side's vector evaluation, eval_utils/distance.py:4-20,
vector_eval.py:51-180, AP.py:6-131):

- ``chamfer_distance``: the symmetric mean closest-point distance of two
  resampled polylines;
- ``interp_fixed_num``: arc-length linear resampling to a fixed count,
  the end points kept;
- ``instance_match``: per sample, the predictions in descending score
  each claim their chamfer-nearest gt if within the threshold and
  unclaimed (thresholds 0.5, 1.0, 1.5 m);
- ``average_precision``: the 'area' mode (the monotone precision envelope
  over recall);
- ``evaluate_vectors``: per class the AP averaged over the thresholds,
  then the mAP over the classes.

preds and gts are per-sample dicts: preds {'vectors': [(M_i, 2)],
'scores': [...], 'labels': [...]}, gts {label: [(N_i, 2)]}.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

INTERP_NUM = 100
THRESHOLDS = (0.5, 1.0, 1.5)


def chamfer_distance(line1: np.ndarray, line2: np.ndarray) -> float:
    d = np.linalg.norm(line1[:, None] - line2[None], axis=-1)
    d12 = d.min(-1).sum() / len(line1)
    d21 = d.min(-2).sum() / len(line2)
    return float((d12 + d21) / 2)


def interp_fixed_num(vector: np.ndarray, num_pts: int = INTERP_NUM
                     ) -> np.ndarray:
    """Arc-length uniform resample, endpoints included."""
    v = np.asarray(vector, np.float64)
    if len(v) == 1:
        return np.repeat(v, num_pts, axis=0)
    seg = np.linalg.norm(np.diff(v, axis=0), axis=-1)
    s = np.concatenate([[0.0], np.cumsum(seg)])
    total = s[-1]
    if total <= 0:
        return np.repeat(v[:1], num_pts, axis=0)
    t = np.linspace(0, total, num_pts)
    x = np.interp(t, s, v[:, 0])
    y = np.interp(t, s, v[:, 1])
    return np.stack([x, y], axis=-1)


def average_precision(recalls: np.ndarray, precisions: np.ndarray) -> float:
    """'area' mode (AP.py:27-38)."""
    mrec = np.concatenate([[0.0], recalls, [1.0]])
    mpre = np.concatenate([[0.0], precisions, [0.0]])
    for i in range(len(mpre) - 1, 0, -1):
        mpre[i - 1] = max(mpre[i - 1], mpre[i])
    ind = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[ind + 1] - mrec[ind]) * mpre[ind + 1]))


def instance_match(pred_lines: np.ndarray, scores: np.ndarray,
                   gt_lines: np.ndarray,
                   thresholds: Sequence[float] = THRESHOLDS):
    """(AP.py:50-131). pred_lines (M, P, 2), gt_lines (N, P, 2).
    Returns [(tp (M,), fp (M,)) per threshold]."""
    m, n = len(pred_lines), len(gt_lines)
    out = []
    if n == 0 or m == 0:
        for _ in thresholds:
            out.append((np.zeros(m, np.float32),
                        np.full(m, float(n == 0), np.float32)
                        if m else np.zeros(m, np.float32)))
        return out
    mat = np.zeros((m, n))
    for i in range(m):
        for j in range(n):
            mat[i, j] = chamfer_distance(pred_lines[i], gt_lines[j])
    mmin = mat.min(axis=1)
    margmin = mat.argmin(axis=1)
    order = np.argsort(-np.asarray(scores))
    for thr in thresholds:
        tp = np.zeros(m, np.float32)
        fp = np.zeros(m, np.float32)
        covered = np.zeros(n, bool)
        for i in order:
            if mmin[i] <= thr:
                g = margmin[i]
                if not covered[g]:
                    covered[g] = True
                    tp[i] = 1
                else:
                    fp[i] = 1
            else:
                fp[i] = 1
        out.append((tp, fp))
    return out


def evaluate_vectors(
    preds: List[Dict],
    gts: List[Dict],
    class_ids: Sequence[int] = (0, 1, 2),
    thresholds: Sequence[float] = THRESHOLDS,
    interp_num: int = INTERP_NUM,
) -> Dict[str, float]:
    """Whole-dataset vector map AP (VectorEvaluate.evaluate)."""
    num_gts = {c: 0 for c in class_ids}
    rows = {c: {t: [] for t in thresholds} for c in class_ids}
    for pred, gt in zip(preds, gts):
        by_cls = {c: ([], []) for c in class_ids}
        for vec, sc, lb in zip(pred.get("vectors", []),
                               pred.get("scores", []),
                               pred.get("labels", [])):
            if lb in by_cls:
                by_cls[lb][0].append(interp_fixed_num(vec, interp_num))
                by_cls[lb][1].append(float(sc))
        for c in class_ids:
            gl = [interp_fixed_num(v, interp_num) for v in gt.get(c, [])]
            num_gts[c] += len(gl)
            pl, sc = by_cls[c]
            tp_fp = instance_match(
                np.asarray(pl) if pl else np.zeros((0, interp_num, 2)),
                np.asarray(sc),
                np.asarray(gl) if gl else np.zeros((0, interp_num, 2)),
                thresholds)
            for t, (tp, fp) in zip(thresholds, tp_fp):
                for tpi, fpi, si in zip(tp, fp, sc):
                    rows[c][t].append((si, tpi, fpi))

    out: Dict[str, float] = {}
    m_ap = []
    eps = np.finfo(np.float32).eps
    for c in class_ids:
        aps = []
        for t in thresholds:
            r = sorted(rows[c][t], key=lambda x: -x[0])
            tp = np.cumsum([x[1] for x in r])
            fp = np.cumsum([x[2] for x in r])
            if len(r) == 0 or num_gts[c] == 0:
                aps.append(0.0)
                out[f"AP_{c}@{t}"] = 0.0
                continue
            rec = tp / max(num_gts[c], eps)
            prec = tp / np.maximum(tp + fp, eps)
            ap = average_precision(rec, prec)
            aps.append(ap)
            out[f"AP_{c}@{t}"] = ap
        out[f"AP_{c}"] = float(np.mean(aps))
        m_ap.append(out[f"AP_{c}"])
    out["mAP"] = float(np.mean(m_ap)) if m_ap else 0.0
    return out
