"""Motion-forecasting metrics: minADE, minFDE, miss rate and EPA.

The port's own copy of ``panacea_tpu/perception/motion_metrics.py`` (NumPy,
on the host; the generation side's eval_utils/ in the reference):

- ``min_ade`` / ``min_fde`` / ``miss_rate`` (metric_utils.py:7-98): the
  best mode's displacement errors over ground-truth futures of ragged
  length (masks in the reference's convention: 1 marks an invalid step).
- ``traj_fde`` (metric_utils.py:95-103): the best mode's FDE at the
  clamped final step, the motion matching's gate.
- ``prediction_metrics`` (eval_utils.py:536-554): a match's (minADE,
  minFDE, miss rate at 2 m).
- ``accumulate_class_motion`` (eval_utils.py:557-726): the devkit's greedy
  matching in confidence order, where a true positive must also bring its
  best trajectory within ``traj_dist_th`` FDE of the matched future; the
  three trajectory errors join the TP-error curves.
- ``evaluate_motion`` (nuscenes_eval_motion.py:575-709): AP at 1 m with
  the trajectory-gated matching and the per-class trajectory metrics, and
  EPA, ``(N_traj_tp - 0.5 N_det_fp) / N_gt`` at 2 m (:666).

preds: per-sample dicts as ``perception/metrics.py`` takes them, with
``trajs`` (N, M, S, 2), the multi-modal futures that
``motion_head.decode_with_traj`` gives. gts also carry ``trajs``: per box
the (V_i, 2) array of its valid future steps.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from panacea_tpu_torch.perception.metrics import (CLASS_NAMES, MIN_PRECISION, MIN_RECALL,
                                                  N_RECALL_PTS, cummean)

TRAJ_TP_METRICS = ("min_ade_err", "min_fde_err", "miss_rate_err")


def min_ade(traj: np.ndarray, traj_gt: np.ndarray, masks: np.ndarray
            ) -> Tuple[np.ndarray, np.ndarray]:
    """traj (B, M, S, 2), traj_gt (B, S, 2), masks (B, S) with 1 = invalid.
    Returns (err, best_mode_idx), both (B,)."""
    m = traj.shape[1]
    gt = np.repeat(traj_gt[:, None], m, axis=1)
    msk = np.repeat(masks[:, None], m, axis=1)
    err = np.sqrt(np.sum((gt - traj[..., :2]) ** 2, axis=3))
    err = np.sum(err * (1 - msk), axis=2) / np.clip(
        np.sum(1 - msk, axis=2), 1, None)
    inds = np.argmin(err, axis=1)
    return np.min(err, axis=1), inds


def min_fde(traj: np.ndarray, traj_gt: np.ndarray, masks: np.ndarray
            ) -> Tuple[np.ndarray, np.ndarray]:
    """Final-step displacement of the best mode (metric_utils.py:33-62)."""
    b, m = traj.shape[:2]
    gt = np.repeat(traj_gt[:, None], m, axis=1)
    lengths = np.sum(1 - masks, axis=1).astype(np.int64)
    fin = np.clip(lengths - 1, 0, None)[:, None]
    idx = np.broadcast_to(fin[..., None, None], (b, m, 1, 2))
    traj_last = np.take_along_axis(traj[..., :2], idx, axis=2)[:, :, 0]
    gt_last = np.take_along_axis(gt, idx, axis=2)[:, :, 0]
    err = np.sqrt(np.sum((gt_last - traj_last) ** 2, axis=2))
    return np.min(err, axis=1), np.argmin(err, axis=1)


def miss_rate(traj: np.ndarray, traj_gt: np.ndarray, masks: np.ndarray,
              dist_thresh: float = 2.0) -> float:
    """Fraction whose best mode's max step error exceeds the threshold
    (metric_utils.py:65-98; invalid steps masked to -inf)."""
    m = traj.shape[1]
    gt = np.repeat(traj_gt[:, None], m, axis=1)
    msk = np.repeat(masks[:, None], m, axis=1).astype(bool)
    dist = np.sqrt(np.sum((gt - traj[..., :2]) ** 2, axis=3))
    dist = np.where(msk, -np.inf, dist)
    dist = np.min(np.max(dist, axis=2), axis=1)
    return float(np.sum(dist > dist_thresh) / len(dist))


def prediction_metrics(gt_traj: np.ndarray, pred_traj: np.ndarray
                       ) -> Tuple[float, float, float]:
    """One match: gt_traj (V, 2) valid steps, pred_traj (M, S, 2).
    (eval_utils.py:536-554)."""
    gt_steps = np.asarray(gt_traj, np.float64).reshape(-1, 2)
    valid = gt_steps.shape[0]
    if valid <= 0:
        return 0.0, 0.0, 0.0
    pred = np.asarray(pred_traj, np.float64)
    s = pred.shape[1]
    gt = np.zeros((s, 2))
    gt[:valid] = gt_steps[:s]
    mask = np.zeros((s,))
    mask[:valid] = 1.0
    ade, _ = min_ade(pred[None], gt[None], 1 - mask[None])
    fde, _ = min_fde(pred[None], gt[None], 1 - mask[None])
    mr = miss_rate(pred[None], gt[None], 1 - mask[None], dist_thresh=2)
    return float(ade[0]), float(fde[0]), float(mr)


def traj_fde(gt_traj: np.ndarray, pred_traj: np.ndarray,
             final_step: int = 12) -> float:
    """Min-over-modes FDE at the clamped final step (metric_utils.py:95)."""
    gt = np.asarray(gt_traj, np.float64).reshape(-1, 2)
    if gt.shape[0] <= 0:
        return np.inf
    fs = min(gt.shape[0], final_step, np.asarray(pred_traj).shape[1])
    gt_final = gt[None, fs - 1]
    pred_final = np.asarray(pred_traj, np.float64)[:, fs - 1, :]
    return float(np.min(np.sqrt(np.sum((gt_final - pred_final) ** 2,
                                       axis=-1))))


def _prep_class_motion(preds, gts, class_name: str, final_step: int):
    """Threshold-independent tables for one class: sorted rows, per-sample
    GT boxes/trajs, npos, and the per-row center-distance / trajectory-FDE
    tables. Computed ONCE and shared by every (dist_th, gate) accumulation
    over the same predictions — the O(rows x GT) traj_fde loop dominates
    motion eval."""
    ident = (class_name, final_step)
    ci = CLASS_NAMES.index(class_name)
    rows = []
    for si, p in enumerate(preds):
        labels = np.asarray(p["labels"])
        mask = labels == ci
        boxes = np.asarray(p["boxes"])[mask]
        trajs = np.asarray(p["trajs"])[mask]
        scores = np.asarray(p["scores"])[mask]
        for b, s, t in zip(boxes, scores, trajs):
            rows.append((float(s), si, b, t))
    npos = sum(int((np.asarray(g["labels"]) == ci).sum()) for g in gts)
    if npos == 0 or not rows:
        return rows, None, None, npos, None, None, ident
    rows.sort(key=lambda r: -r[0])

    gt_boxes, gt_trajs = [], []
    for g in gts:
        mask = np.asarray(g["labels"]) == ci
        gt_boxes.append(np.asarray(g["boxes"])[mask])
        gt_trajs.append([t for t, m in zip(g["trajs"], mask) if m])

    dists, fdes = [], []
    for score, si, box, ptraj in rows:
        g = gt_boxes[si]
        dists.append(np.linalg.norm(box[None, :2] - g[:, :2], axis=-1)
                     if len(g) else np.zeros((0,)))
        fdes.append(np.asarray([
            traj_fde(gt_trajs[si][gi], ptraj, final_step)
            for gi in range(len(g))]))
    return rows, gt_boxes, gt_trajs, npos, dists, fdes, ident


def accumulate_class_motion(
    preds: List[Dict],
    gts: List[Dict],
    class_name: str,
    dist_th: float,
    traj_dist_th: float = 2.0,
    final_step: int = 12,
    gate_on_traj: bool = True,
    also_ungated: bool = False,
    prep=None,
) -> Tuple:
    """One (class, threshold) accumulation. ``gate_on_traj=True`` is the
    reference ``accumulate_motion`` (a TP must also have trajectory FDE <
    ``traj_dist_th`` for the closest GT); False is plain ``accumulate``.
    Returns (AP, tp_errors incl. the three traj metrics, N_tp, N_fp, npos);
    with ``also_ungated`` additionally (det_N_tp, det_N_fp) from the plain
    matching over the SAME precomputed distances (one pass serves both
    halves of the EPA formula, nuscenes_eval_motion.py:661-666).
    ``prep``: the output of ``_prep_class_motion`` — pass it to share the
    distance/FDE tables across gates (they do not depend on dist_th). The
    prep carries its (class_name, final_step) identity; a mismatch with
    this call's arguments raises rather than silently computing metrics
    for the wrong class/horizon."""
    if prep is None:
        prep = _prep_class_motion(preds, gts, class_name, final_step)
    rows, gt_boxes, gt_trajs, npos, dists, fdes, ident = prep
    if ident != (class_name, final_step):
        raise ValueError(
            f"prep was built for (class, final_step)={ident}, but this "
            f"call passed {(class_name, final_step)}")
    # devkit corner (eval_utils.py:585-586, 758-759): a class missing from
    # GT or with zero predictions returns no_predictions() -> AP 0.0 and TP
    # errors 1.0, which DO enter the aggregation means
    empty = {m: 1.0 for m in TRAJ_TP_METRICS + ("trans_err",)}
    if npos == 0 or not rows:
        base = (0.0, empty, 0, 0, npos)
        return base + (0, 0) if also_ungated else base

    def match_rows(gate: bool):
        """Devkit greedy matching (eval_utils.py:744-775): closest un-taken
        GT; its traj FDE rides along with the argmin."""
        taken = [np.zeros(len(g), dtype=bool) for g in gt_boxes]
        tp, fp, matched = [], [], []
        for ri, (score, si, box, ptraj) in enumerate(rows):
            d = np.where(taken[si], np.inf, dists[ri])
            best = int(np.argmin(d)) if len(d) else -1
            best_d = float(d[best]) if len(d) else np.inf
            is_match = best_d < dist_th and (
                not gate or fdes[ri][best] < traj_dist_th)
            if is_match:
                taken[si][best] = True
                tp.append(1)
                fp.append(0)
                matched.append((ri, si, best, best_d))
            else:
                tp.append(0)
                fp.append(1)
        return tp, fp, matched

    tp, fp, matched = match_rows(gate_on_traj)
    conf = [r[0] for r in rows]
    match_err = {m: [] for m in TRAJ_TP_METRICS + ("trans_err",)}
    match_conf = []
    for ri, si, gi, best_d in matched:
        ade, fde, mr = prediction_metrics(gt_trajs[si][gi], rows[ri][3])
        match_err["trans_err"].append(best_d)
        match_err["min_ade_err"].append(ade)
        match_err["min_fde_err"].append(fde)
        match_err["miss_rate_err"].append(mr)
        match_conf.append(rows[ri][0])

    n_tp, n_fp = int(np.sum(tp)), int(np.sum(fp))
    tp = np.cumsum(tp).astype(np.float64)
    fp = np.cumsum(fp).astype(np.float64)
    prec = tp / np.maximum(tp + fp, 1e-9)
    rec = tp / npos
    rec_interp = np.linspace(0, 1, N_RECALL_PTS)
    prec_i = np.interp(rec_interp, rec, prec, right=0)
    conf_i = np.interp(rec_interp, rec, conf, right=0)
    p = np.copy(prec_i)[round(100 * MIN_RECALL) + 1:]
    p -= MIN_PRECISION
    p[p < 0] = 0
    ap = float(np.mean(p)) / (1.0 - MIN_PRECISION)

    tp_out = {}
    nonzero = np.nonzero(conf_i)[0]
    max_recall_ind = int(nonzero[-1]) if len(nonzero) else 0
    first_ind = round(100 * MIN_RECALL) + 1
    for m in match_err:
        if max_recall_ind < first_ind or not match_err[m]:
            tp_out[m] = 1.0
            continue
        tmp = cummean(np.asarray(match_err[m], dtype=np.float64))
        curve = np.interp(conf_i[::-1], np.asarray(match_conf)[::-1],
                          tmp[::-1])[::-1]
        tp_out[m] = float(np.mean(curve[first_ind:max_recall_ind + 1]))
    if also_ungated:
        tp_u, fp_u, _ = match_rows(False)
        return (ap, tp_out, n_tp, n_fp, npos,
                int(np.sum(tp_u)), int(np.sum(fp_u)))
    return ap, tp_out, n_tp, n_fp, npos


def evaluate_motion(
    preds: List[Dict],
    gts: List[Dict],
    class_names: Sequence[str] = CLASS_NAMES,
    final_step: int = 12,
) -> Dict[str, float]:
    """Both reference protocols in one pass:

    - motion metrics at the 1 m gate (evaluate_motion,
      nuscenes_eval_motion.py:584-586): mAP_motion + mean minADE/minFDE/MR
      over classes;
    - EPA at the 2 m gate (evaluate_epa, :647-666): per-class
      ``(N_traj_tp - 0.5 * N_det_fp) / (N_gt + 1e-5)`` where the FP count
      comes from the PLAIN (non-trajectory-gated) matching.
    """
    out: Dict[str, float] = {}
    aps, ades, fdes, mrs, epas = [], [], [], [], []
    for cname in class_names:
        prep = _prep_class_motion(preds, gts, cname, final_step)
        ap, tps, *_ = accumulate_class_motion(
            preds, gts, cname, dist_th=1.0, traj_dist_th=2.0,
            final_step=final_step, prep=prep)
        _, _, traj_tp, _, n_gt, _, det_fp = accumulate_class_motion(
            preds, gts, cname, dist_th=2.0, traj_dist_th=2.0,
            final_step=final_step, also_ungated=True, prep=prep)
        epa = (traj_tp - 0.5 * det_fp) / (n_gt + 1e-5)
        out[f"AP_motion_{cname}"] = ap
        out[f"EPA_{cname}"] = float(epa)
        # devkit aggregation: GT-missing classes contribute AP 0 / TP 1.0
        # (no_predictions) — nothing is skipped
        aps.append(ap)
        epas.append(epa)
        for acc, key in ((ades, "min_ade_err"), (fdes, "min_fde_err"),
                         (mrs, "miss_rate_err")):
            acc.append(tps[key])
    out["mAP_motion"] = float(np.mean(aps)) if aps else float("nan")
    out["minADE"] = float(np.mean(ades)) if ades else float("nan")
    out["minFDE"] = float(np.mean(fdes)) if fdes else float("nan")
    out["miss_rate"] = float(np.mean(mrs)) if mrs else float("nan")
    out["EPA"] = float(np.mean(epas)) if epas else float("nan")
    return out
