"""StreamPETR perception of the port: the eval (ResNet-50 + FPN + SparseHead,
``detector.StreamPETRWindow``; the NMS-free decoder, the nuScenes metric, the
Gen-nuScenes eval dataset and the CLI ``eval.py``) and the training of the
recipes (the ATSS head, the DN queries, GridMask, the losses with the
Hungarian matching, the training dataset, ``train.py`` and the CLI
``train_cli.py``; ``detector.StreamPETR`` for the streaming recipes).

Counterpart of ``panacea_tpu/perception``: the recipes' detector
(``backbone_type="r50"``, ``head_type="sparse"``) and the zoo (VoVNet-99,
EVA-02, the dense PETR heads, the proposal-query heads, FocalHead and the
DETR3D family's loss). Module names are the
reference's mmdet ones (``img_backbone``, ``img_neck``, ``pts_bbox_head``,
``img_roi_head``), so a StreamPETR ``.pth`` loads without a converter.

The rest of the zoo (SimMOD with its FCOS proposals and two-stage
attention, the joint 2D-to-3D heads, cascade RoI, YOLOX, their losses,
the vector-map AP and the eval filters) is exported below.
"""

from panacea_tpu_torch.perception import (
    cascade_roi,
    eval_filters,
    fcos_proposal,
    joint_head,
    simmod,
    twostage_attn,
    vector_metrics,
    vestigial_train,
    yolox_head,
)

__all__ = ["cascade_roi", "eval_filters", "fcos_proposal", "joint_head", "simmod",
           "twostage_attn", "vector_metrics", "vestigial_train", "yolox_head"]
