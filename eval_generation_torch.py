#!/usr/bin/env python3
"""FID/FVD CLI of the PyTorch/CUDA port: ``panacea_tpu_torch.metrics_gen.eval``.

    python eval_generation_torch.py --synthetic                    # on the card
    python eval_generation_torch.py --synthetic --device cpu
    python eval_generation_torch.py --real_root <dir> --gen_root <dir> \\
        --inception_ckpt <pth> --i3d_ckpt <pt>
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from panacea_tpu_torch.metrics_gen.eval import main  # noqa: E402

if __name__ == "__main__":
    main()
