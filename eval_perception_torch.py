#!/usr/bin/env python3
"""Perception eval CLI of the PyTorch/CUDA port: ``panacea_tpu_torch.perception.eval``.

    python eval_perception_torch.py --synthetic                     # on the card
    python eval_perception_torch.py --synthetic --tiny --device cpu
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from panacea_tpu_torch.perception.eval import main  # noqa: E402

if __name__ == "__main__":
    main()
