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
"""
