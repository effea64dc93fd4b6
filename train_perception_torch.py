#!/usr/bin/env python3
"""Perception training CLI of the PyTorch/CUDA port: ``panacea_tpu_torch.perception.train_cli``.

    python train_perception_torch.py --config streampetr_r50_atss_512x256_window   # on the card
    python train_perception_torch.py --synthetic --tiny --steps 2 --device cpu
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from panacea_tpu_torch.perception.train_cli import main  # noqa: E402

if __name__ == "__main__":
    main()
