#!/usr/bin/env python3
"""Training CLI of the PyTorch/CUDA port: ``panacea_tpu_torch.train``.

    python train_torch.py --synthetic --steps 10 --use_ema          # on the card
    python train_torch.py --tiny --synthetic --steps 3 --ckpt_every 0 --device cpu
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from panacea_tpu_torch.train import main  # noqa: E402

if __name__ == "__main__":
    main()
