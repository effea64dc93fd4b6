#!/usr/bin/env python3
"""Inference CLI of the PyTorch/CUDA port: ``panacea_tpu_torch.inference``.

    python inference_torch.py --synthetic --num_batches 1          # on the card
    python inference_torch.py --synthetic --tiny --device cpu --num_batches 1
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from panacea_tpu_torch.inference import main  # noqa: E402

if __name__ == "__main__":
    main()
