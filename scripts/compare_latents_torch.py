#!/usr/bin/env python3
"""Fixed-seed latent-trajectory dump of the PyTorch/CUDA port.

Counterpart of ``scripts/compare_latents.py dump``: the port's engine runs
the production EulerEDM sampler with ``return_trajectory=True`` on NumPy noise
from ``np.random.RandomState(seed)`` and the same seeded conditioning batch,
and writes one npz in that script's layout (``traj``, ``final``, ``noise``,
``jpg``, ``cond_img``, ``txt``, ``num_steps``, ``seed``, ``cond_*``,
``uc_*``), so that its ``compare`` mode reads a dump of either package:

  python scripts/compare_latents_torch.py dump --tiny --device cpu \\
      --ckpt x.ckpt --out torch.npz --num_steps 2
  python scripts/compare_latents.py dump --tiny --ckpt x.ckpt --out jax.npz --num_steps 2
  python scripts/compare_latents.py compare torch.npz jax.npz --atol 1e-3

Without ``--ckpt`` the weights are random from seed 0 and differ between the
packages. On the card the network runs in bf16, on the CPU in fp32.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def dump(args) -> None:
    import torch

    from panacea_tpu_torch.checkpoint import load_checkpoint
    from panacea_tpu_torch.config import load_config
    from panacea_tpu_torch.registry import instantiate_from_config

    cfg = load_config("tiny_cpu" if args.tiny else "inference_nuscenes")
    eng = instantiate_from_config(cfg["model"], device=args.device)
    eng.init_weights(torch.Generator(device=eng.device).manual_seed(0))
    if args.ckpt:
        load_checkpoint(args.ckpt, eng)

    t = eng.num_frames
    if args.tiny:
        ih, iw = 16, 192
        lh, lw = 2, 24
    else:
        ih, iw = 256, 3072
        lh, lw = 32, 384

    # the draws of compare_latents.py dump, in its order
    rs = np.random.RandomState(args.seed)
    batch = {
        "jpg": rs.uniform(-1, 1, (1, t, ih, iw, 3)).astype(np.float32),
        "cond_img": rs.uniform(0, 1, (1, t, ih, iw, 19)).astype(np.float32),
        "final_cond_zero": np.zeros((1, t, ih, iw, 3), np.float32),
        "txt": [args.prompt],
    }
    c, uc = eng.conditioner.get_unconditional_conditioning(
        batch, dict(batch, txt=[""]), eng.device)
    noise = rs.standard_normal((t, lh, lw, 4)).astype(np.float32)

    final, traj = eng.sample(c, uc=uc, batch_size=t, shape=(lh, lw, 4),
                             num_steps=args.num_steps, noise=torch.from_numpy(noise),
                             return_trajectory=True)

    def host(x):
        return x.detach().float().cpu().numpy()

    cond_arrs = {f"cond_{k}": host(v) for k, v in c.items()}
    cond_arrs.update({f"uc_{k}": host(v) for k, v in uc.items()})
    np.savez_compressed(
        args.out, traj=host(traj), final=host(final), noise=noise,
        jpg=batch["jpg"], cond_img=batch["cond_img"],
        txt=np.array([args.prompt]), num_steps=np.array(args.num_steps),
        seed=np.array(args.seed), **cond_arrs)
    print(f"dumped {traj.shape[0]} per-step latents "
          f"{tuple(traj.shape[1:])} + cond tensors "
          f"{sorted(cond_arrs)} -> {args.out}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="mode", required=True)
    d = sub.add_parser("dump")
    d.add_argument("--out", required=True)
    d.add_argument("--ckpt", default=None, help="reference checkpoint (.ckpt)")
    d.add_argument("--tiny", action="store_true")
    d.add_argument("--num_steps", type=int, default=25)
    d.add_argument("--seed", type=int, default=0)
    d.add_argument("--prompt", default="a driving scene. daytime. sunny.")
    d.add_argument("--device", default=None,
                   help="torch device; default cuda, which raises without a card")
    dump(ap.parse_args(argv))


if __name__ == "__main__":
    main()
