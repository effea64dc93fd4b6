"""nuScenes detection metrics: per-class AP over center-distance thresholds,
TP errors (ATE/ASE/AOE/AVE/AAE), and the NDS composite.

The port's own copy of ``panacea_tpu/perception/metrics.py`` (NumPy only),
which reimplements the nuscenes-devkit evaluation math the reference harness
delegates to (metrics/StreamPETR via mmdet3d NuScenesDataset.evaluate):
  * greedy score-ordered matching by BEV center distance in {0.5, 1, 2, 4} m
  * 101-point interpolated AP with 10% recall/precision floors
  * TP errors averaged over the recall range above 10%, at the 2 m threshold
  * NDS = (5*mAP + sum_tp max(0, 1 - mTP)) / 10

Boxes are 9-dim (cx, cy, cz, w, l, h, yaw, vx, vy) in global/ego coordinates.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

DIST_THRESHOLDS = (0.5, 1.0, 2.0, 4.0)
TP_METRICS = ("trans_err", "scale_err", "orient_err", "vel_err", "attr_err")
MIN_RECALL = 0.1
MIN_PRECISION = 0.1
N_RECALL_PTS = 101

CLASS_NAMES = (
    "car", "truck", "construction_vehicle", "bus", "trailer", "barrier",
    "motorcycle", "bicycle", "pedestrian", "traffic_cone",
)
# classes without orientation / velocity / attribute in the devkit
NO_VEL = ("barrier", "traffic_cone")
NO_ATTR = ("barrier", "traffic_cone")
# barrier orientation is period-pi
PERIOD_PI = ("barrier",)


# mmdet3d NuScenesDataset.DefaultAttribute (reference eval harness assigns
# these when serializing predictions, nuscenes_dataset.py:524-544)
DEFAULT_ATTRIBUTE = {
    "car": "vehicle.parked",
    "pedestrian": "pedestrian.moving",
    "trailer": "vehicle.parked",
    "truck": "vehicle.parked",
    "bus": "vehicle.moving",
    "motorcycle": "cycle.without_rider",
    "construction_vehicle": "vehicle.parked",
    "bicycle": "cycle.without_rider",
    "barrier": "",
    "traffic_cone": "",
}


def assign_attributes(boxes: np.ndarray, labels: np.ndarray) -> List[str]:
    """Predicted attribute per box by the reference's velocity-threshold rule
    (metrics/.../nuscenes_dataset.py:524-544): speed > 0.2 m/s makes vehicles
    'vehicle.moving' and cycles 'cycle.with_rider'; otherwise pedestrians are
    'pedestrian.standing', buses 'vehicle.stopped', else the class default."""
    out = []
    for b, li in zip(np.asarray(boxes), np.asarray(labels)):
        name = CLASS_NAMES[int(li)]
        speed = float(np.hypot(b[7], b[8])) if len(b) >= 9 else 0.0
        if speed > 0.2:
            if name in ("car", "construction_vehicle", "bus", "truck",
                        "trailer"):
                attr = "vehicle.moving"
            elif name in ("bicycle", "motorcycle"):
                attr = "cycle.with_rider"
            else:
                attr = DEFAULT_ATTRIBUTE[name]
        else:
            if name == "pedestrian":
                attr = "pedestrian.standing"
            elif name == "bus":
                attr = "vehicle.stopped"
            else:
                attr = DEFAULT_ATTRIBUTE[name]
        out.append(attr)
    return out


def cummean(x: np.ndarray) -> np.ndarray:
    """Devkit cumulative nan-mean (nuscenes/eval/common/utils.py): all-nan
    input yields ones."""
    if np.all(np.isnan(x)):
        return np.ones(len(x))
    sum_vals = np.nancumsum(x.astype(np.float64))
    count_vals = np.cumsum(~np.isnan(x))
    return np.divide(sum_vals, count_vals,
                     out=np.zeros_like(sum_vals), where=count_vals > 0)


def yaw_diff(a: float, b: float, period: float = 2 * np.pi) -> float:
    d = (a - b) % period
    return min(d, period - d)


def aligned_iou_1d(p: np.ndarray, g: np.ndarray) -> float:
    """Scale error: 1 - IoU of size-aligned, center-aligned boxes."""
    inter = np.prod(np.minimum(p, g))
    union = np.prod(p) + np.prod(g) - inter
    return inter / max(union, 1e-9)


def accumulate_class(
    preds: List[Dict],
    gts: List[Dict],
    class_name: str,
    dist_th: float,
) -> Tuple[float, Dict[str, float]]:
    """One (class, threshold) accumulation over all samples.

    preds/gts: per-sample dicts with 'boxes' (N,9), 'labels' (N,), 'scores'
    (preds only), 'names' optional. Returns (AP, tp_errors)."""
    ci = CLASS_NAMES.index(class_name)
    # gather all predictions of this class with sample ids
    rows = []
    for si, p in enumerate(preds):
        labels = np.asarray(p["labels"])
        mask = labels == ci
        attrs = (list(p["attrs"]) if "attrs" in p
                 else assign_attributes(p["boxes"], labels))
        attrs = [a for a, m in zip(attrs, mask) if m]
        for b, s, a in zip(np.asarray(p["boxes"])[mask],
                           np.asarray(p["scores"])[mask], attrs):
            rows.append((s, si, b, a))
    npos = sum(int((np.asarray(g["labels"]) == ci).sum()) for g in gts)
    # devkit corner cases (algo.py accumulate): a class missing from GT, or
    # one with zero predictions/matches, returns the no_predictions() curve
    # -> AP 0.0 and TP errors 1.0, which DO enter the aggregation means
    empty_tp = {m: 1.0 for m in TP_METRICS}
    if npos == 0 or not rows:
        return 0.0, empty_tp
    rows.sort(key=lambda r: -r[0])

    gt_boxes = [np.asarray(g["boxes"])[np.asarray(g["labels"]) == ci]
                for g in gts]
    gt_attrs = []
    for g in gts:
        mask = np.asarray(g["labels"]) == ci
        if "attrs" in g:
            gt_attrs.append([a for a, m in zip(g["attrs"], mask) if m])
        else:
            gt_attrs.append([""] * int(mask.sum()))
    taken = [np.zeros(len(g), dtype=bool) for g in gt_boxes]

    tp, fp, conf = [], [], []
    match_err = {m: [] for m in TP_METRICS}
    match_conf = []
    for score, si, box, pattr in rows:
        g = gt_boxes[si]
        best, best_d = -1, float(dist_th)
        for gi in range(len(g)):
            if taken[si][gi]:
                continue
            d = np.linalg.norm(box[:2] - g[gi][:2])
            if d < best_d:
                best, best_d = gi, d
        if best >= 0:
            taken[si][best] = True
            tp.append(1)
            fp.append(0)
            gt = g[best]
            match_err["trans_err"].append(best_d)
            match_err["scale_err"].append(
                1.0 - aligned_iou_1d(box[3:6], gt[3:6])
            )
            period = np.pi if class_name in PERIOD_PI else 2 * np.pi
            match_err["orient_err"].append(
                0.0 if class_name == "traffic_cone"
                else yaw_diff(box[6], gt[6], period)
            )
            match_err["vel_err"].append(
                0.0 if class_name in NO_VEL
                else float(np.linalg.norm(box[7:9] - gt[7:9]))
            )
            # devkit attr_acc: nan when the GT box carries no attribute,
            # else exact-match accuracy (nuscenes/eval/common/utils.py)
            ga = gt_attrs[si][best]
            match_err["attr_err"].append(
                np.nan if ga == "" else 1.0 - float(pattr == ga))
            match_conf.append(score)
        else:
            tp.append(0)
            fp.append(1)
        conf.append(score)

    tp = np.cumsum(tp).astype(np.float64)
    fp = np.cumsum(fp).astype(np.float64)
    prec = tp / np.maximum(tp + fp, 1e-9)
    rec = tp / npos

    rec_interp = np.linspace(0, 1, N_RECALL_PTS)
    prec_i = np.interp(rec_interp, rec, prec, right=0)
    conf_i = np.interp(rec_interp, rec, conf, right=0)

    # AP with recall/precision floors (devkit calc_ap)
    p = np.copy(prec_i)
    p = p[round(100 * MIN_RECALL) + 1:]
    p -= MIN_PRECISION
    p[p < 0] = 0
    ap = float(np.mean(p)) / (1.0 - MIN_PRECISION)

    # TP-error curves on the interpolated-confidence grid, then averaged from
    # MIN_RECALL to the max achieved recall (devkit accumulate tail + calc_tp)
    tp_out = {}
    nonzero = np.nonzero(conf_i)[0]
    max_recall_ind = int(nonzero[-1]) if len(nonzero) else 0
    first_ind = round(100 * MIN_RECALL) + 1
    for m in TP_METRICS:
        if max_recall_ind < first_ind or not match_err[m]:
            tp_out[m] = 1.0
            continue
        tmp = cummean(np.asarray(match_err[m], dtype=np.float64))
        curve = np.interp(conf_i[::-1], np.asarray(match_conf)[::-1],
                          tmp[::-1])[::-1]
        tp_out[m] = float(np.mean(curve[first_ind:max_recall_ind + 1]))
    return ap, tp_out


def evaluate_detections(
    preds: List[Dict],
    gts: List[Dict],
    class_names: Sequence[str] = CLASS_NAMES,
) -> Dict[str, float]:
    """Full evaluation: returns mAP, mATE/mASE/mAOE/mAVE/mAAE, NDS and
    per-class APs."""
    aps = {}
    tp_errors = {m: [] for m in TP_METRICS}
    for cname in class_names:
        class_aps = []
        for th in DIST_THRESHOLDS:
            ap, tps = accumulate_class(preds, gts, cname, th)
            class_aps.append(ap)
            if th == 2.0:
                for m in TP_METRICS:
                    skip = (
                        (m == "vel_err" and cname in NO_VEL)
                        or (m == "attr_err" and cname in NO_ATTR)
                        or (m == "orient_err" and cname == "traffic_cone")
                    )
                    if not skip:
                        tp_errors[m].append(tps[m])
        aps[cname] = float(np.mean(class_aps))
    m_ap = float(np.mean(list(aps.values())))
    out = {"mAP": m_ap}
    names = {"trans_err": "mATE", "scale_err": "mASE", "orient_err": "mAOE",
             "vel_err": "mAVE", "attr_err": "mAAE"}
    nds_terms = [5.0 * m_ap]
    for m in TP_METRICS:
        v = float(np.mean(tp_errors[m])) if tp_errors[m] else 1.0
        out[names[m]] = v
        nds_terms.append(max(0.0, 1.0 - min(1.0, v)))
    out["NDS"] = float(sum(nds_terms) / 10.0)
    for c, v in aps.items():
        out[f"AP_{c}"] = v
    return out
