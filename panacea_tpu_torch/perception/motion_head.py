"""PETRMotionHead: StreamPETRHead with multi-modal trajectories, and its
training loss.

Counterpart of ``panacea_tpu/perception/motion_head.py`` (the generation
side's vendored plugin, petr_motion_head.py:45-1123, losses/traj_loss.py,
nms_free_coder.py:147-205):

- ``PETRMotionHead``: on every decoder layer's post-normed output, a
  learned embedding per mode is added and one shared MLP emits
  ``pred_steps`` xy offsets and a mode score; the offsets are summed over
  time and anchored at the (detached) predicted box centre
  (petr_motion_head.py:655-670). The reference repeats one branch module
  over the layers; the port holds it once, as ``traj_branches.0``, as the
  cls and reg branches.
- ``traj_targets_from_assignment``: the matched ground-truth trajectories
  scattered onto the queries (:774-787).
- ``traj_loss_v1`` (TrajLossv1): best-of-modes L1 ADE, L1 FDE and the NLL
  of the best mode's score, over the positive count, the reference's
  quirks kept (the FDE mode chosen on fde times the valid steps, the
  regression over a fixed 12).
- ``decode_with_traj`` (NMSFreeCoderPred.decode): each decoded box with its
  trajectories, modes by score, the best ``max_modes`` kept.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from panacea_tpu_torch.perception.petr_head import StreamPETRHead


class PETRMotionHead(StreamPETRHead):
    """``pred_steps`` future xy steps (12: 6 s at 2 Hz) for each of ``mode``
    hypotheses a query (petr_motion_head.py:86-87)."""

    def __init__(self, *, pred_steps: int = 12, mode: int = 6, **kwargs):
        super().__init__(**kwargs)
        c = self.embed_dims
        self.pred_steps, self.mode = pred_steps, mode
        self.traj_embedding = nn.Embedding(mode, c)
        layers = []
        for _ in range(self.num_reg_fcs):
            layers += [nn.Linear(c, c), nn.ReLU()]
        self.traj_branches = nn.ModuleList([nn.Sequential(*layers,
                                                          nn.Linear(c, pred_steps * 2 + 1))])

    def head_extras(self, outs: Dict[str, torch.Tensor], outs_dec: torch.Tensor):
        """(L, B, Q, C) -> all_traj_preds (L, B, Q, M, S, 2) and
        all_traj_scores (L, B, Q, M)."""
        tmp = self.traj_branches[0](outs_dec[..., None, :] + self.traj_embedding.weight)
        preds = tmp[..., 1:].unflatten(-1, (self.pred_steps, 2)).cumsum(dim=-2)
        anchor = outs["all_bbox_preds"][..., 0:2].detach()
        outs["all_traj_preds"] = preds + anchor[..., None, None, :]
        outs["all_traj_scores"] = tmp[..., 0]
        return outs


def traj_targets_from_assignment(traj_shape: Tuple[int, ...], pos_mask: torch.Tensor,
                                 assigned_gt: torch.Tensor, gt_trajs: torch.Tensor,
                                 gt_trajs_mask: torch.Tensor):
    """One sample's targets (petr_motion_head.py:774-787): a query matched
    to a ground truth takes its future trajectory and validity over every
    mode; the others stay 0. traj_shape (Q, M, S, 2); pos_mask (Q,) bool;
    assigned_gt (Q,) (any value off ``pos_mask``); gt_trajs and
    gt_trajs_mask (G, S, 2). Returns (targets, weights), (Q, M, S, 2)."""
    q, m = traj_shape[0], traj_shape[1]
    idx = assigned_gt.long().clamp(0, max(gt_trajs.shape[0] - 1, 0))
    sel = pos_mask[:, None, None, None]
    zero = gt_trajs.new_zeros(())
    targets = torch.where(sel, gt_trajs[idx][:, None].expand(q, m, -1, -1), zero)
    weights = torch.where(sel, gt_trajs_mask[idx][:, None].expand(q, m, -1, -1).to(zero.dtype),
                          zero)
    return targets, weights


def traj_loss_v1(traj_prob: torch.Tensor, traj_preds: torch.Tensor, gt_traj: torch.Tensor,
                 gt_traj_mask: torch.Tensor, avg_factor, cls_loss_weight: float = 1.0,
                 ade_loss_weight: float = 1.0, fde_loss_weight: float = 0.25) -> torch.Tensor:
    """TrajLossv1 (losses/traj_loss.py:16-95). traj_prob (B, Q, M);
    traj_preds (B, Q, M, S, 2); gt_traj and gt_traj_mask (B Q, M, S, 2);
    avg_factor the positive count."""
    preds = traj_preds.reshape((-1,) + tuple(traj_preds.shape[2:]))       # (BQ, M, S, 2)
    logp = F.log_softmax(traj_prob.reshape(-1, traj_prob.shape[-1]), dim=-1)   # (BQ, M)
    mask = gt_traj_mask[..., 0]                                           # (BQ, M, S)
    valid_steps = mask.sum(dim=-1)                                        # (BQ, M)
    fin = (valid_steps - 1).clamp(min=0).long()
    fin_idx = fin[..., None, None].expand(fin.shape + (1, 2))
    pred_final = torch.gather(preds, 2, fin_idx)                          # (BQ, M, 1, 2)
    gt_final = torch.gather(gt_traj, 2, fin_idx)

    def norm(x):
        return torch.sqrt((x * x).sum(dim=-1))

    fde_mode = torch.argmin((norm(pred_final - gt_final) * mask).sum(-1), dim=1)
    best_mode = torch.argmin((norm(preds - gt_traj) * mask).sum(-1), dim=1)

    def gather_mode(x, idx):
        ii = idx.reshape((-1,) + (1,) * (x.dim() - 1)).expand((x.shape[0], 1) + x.shape[2:])
        return torch.gather(x, 1, ii)

    fde_best = gather_mode(pred_final, fde_mode)                          # (BQ, 1, 1, 2)
    pred_best = gather_mode(preds, best_mode)                             # (BQ, 1, S, 2)
    cls_best = gather_mode(logp, best_mode)                               # (BQ, 1)
    reg_mask = mask[:, :1, :, None]
    l_reg = (gt_traj[:, :1] - pred_best).abs() * reg_mask
    l_min_fde = (gt_final[:, 0:1] - fde_best).abs() * reg_mask[:, :, 0:1]
    l_class = -cls_best * (valid_steps > 0).to(logp.dtype)[:, 0:1]
    avg = torch.clamp(torch.as_tensor(avg_factor, dtype=torch.float32, device=preds.device),
                      min=1e-5)
    loss = (l_class.sum() / avg * cls_loss_weight + l_reg.sum() / (avg * 12) * ade_loss_weight
            + l_min_fde.sum() / avg * fde_loss_weight)
    return torch.nan_to_num(loss)


def decode_with_traj(coder, preds: Dict[str, torch.Tensor], max_modes: int = 6) -> List[Dict]:
    """``coder.decode(preds)`` (an ``NMSFreeCoder``), each kept box with its
    trajectories (``trajs``, aliased as the reference's ``traj``: (k,
    max_modes, S, 2)) and their scores, modes in descending score."""
    outs = coder.decode(preds)
    traj = preds["all_traj_preds"][-1].detach().cpu().numpy()             # (B, Q, M, S, 2)
    traj_scores = preds["all_traj_scores"][-1].detach().cpu().numpy()     # (B, Q, M)
    for i, o in enumerate(outs):
        box = np.asarray(o["box_idx"])
        tr, ts = traj[i][box], traj_scores[i][box]
        mode_idx = np.argsort(-ts, axis=-1)[:, :min(max_modes, ts.shape[-1])]
        o["trajs"] = o["traj"] = np.take_along_axis(tr, mode_idx[..., None, None], axis=1)
        o["traj_scores"] = np.take_along_axis(ts, mode_idx, axis=-1)
    return outs
