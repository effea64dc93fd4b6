"""The StreamPETR perception eval of the port: ResNet-50 + FPN + SparseHead
(``detector.StreamPETRWindow``), the NMS-free decoder, the nuScenes metric,
the Gen-nuScenes eval dataset and the CLI (``eval.py``).

Counterpart of ``panacea_tpu/perception`` at the eval recipe
(``backbone_type="r50"``, ``head_type="sparse"``). Module names are the
reference's mmdet ones (``img_backbone``, ``img_neck``, ``pts_bbox_head``),
so a StreamPETR ``.pth`` loads without a converter.
"""
