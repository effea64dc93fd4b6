"""FID / FVD between a real and a generated frame tree, on the card.

Counterpart of the JAX package's root ``eval_generation.py``, with its
flags, defaults and last JSON line, and ``--device``. It walks two
directories of per-view frame images (the layout ``inference_torch.py``
writes: ``<root>/<view>_<sample>/_00000<i>.jpg``, the Gen-nuScenes eval
layout), extracts InceptionV3 pooled features of every frame at 299 x 299
(FID) and I3D features of every clip of ``--num_frames`` frames at 224 x 224
(FVD), two clips a batch, and prints both. The towers run in fp32 with TF32
off; the feature statistics accumulate in float64 on the same device.

Weights: ``--inception_ckpt`` / ``--i3d_ckpt`` take torch state dicts under
torchvision's / pytorch-i3d's names (a ``state_dict`` entry and DeepSpeed's
``_forward_module.`` prefix are unwrapped). The names the towers do not have
(``AuxLogits.*``, ``fc.*``, ``num_batches_tracked``) are dropped and counted
on stderr; every name of the tower is required. Without both checkpoints the
towers are random (from seed 0): the CLI refuses to score directories then,
unless ``--allow_random_towers`` (pipeline smoke only), and stamps the JSON.

  python eval_generation_torch.py --real_root <dir> --gen_root <dir> \\
      --inception_ckpt pt_inception.pth --i3d_ckpt rgb_imagenet.pt
  python eval_generation_torch.py --synthetic --device cpu
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

INCEPTION_HW, I3D_HW = (299, 299), (224, 224)
CLIPS_PER_BATCH = 2
# checkpoint names outside the feature towers (the JAX mappings leave them unmapped)
DROPPED_PREFIXES = ("AuxLogits.", "fc.")
DROPPED_SUFFIX = ".num_batches_tracked"


def get_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--real_root", help="dir of per-clip frame dirs (real)")
    ap.add_argument("--gen_root", help="dir of per-clip frame dirs (generated)")
    ap.add_argument("--inception_ckpt", default=None)
    ap.add_argument("--i3d_ckpt", default=None)
    ap.add_argument("--num_frames", type=int, default=8)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--max_clips", type=int, default=0)
    ap.add_argument("--synthetic", action="store_true",
                    help="self-test on random data (no dirs needed)")
    ap.add_argument("--allow_random_towers", action="store_true",
                    help="permit FID/FVD from random-init Inception/I3D "
                         "(pipeline smoke ONLY — numbers are meaningless; "
                         "the output JSON is stamped 'towers':'random-init')")
    ap.add_argument("--device", default=None,
                    help="torch device; default cuda, which raises without a "
                         "card. 'cpu' is for tests")
    return ap


def collect_clips(root: str, num_frames: int = 8) -> Dict[str, List[str]]:
    """clip dir -> ordered frame paths (dirs with >= num_frames images)."""
    clips = {}
    for d in sorted(os.listdir(root)):
        full = os.path.join(root, d)
        if not os.path.isdir(full):
            continue
        frames = sorted(os.path.join(full, f) for f in os.listdir(full)
                        if f.lower().endswith((".jpg", ".jpeg", ".png")))
        if len(frames) >= num_frames:
            clips[d] = frames[:num_frames]
    return clips


def load_image(path: str, hw) -> np.ndarray:
    """(H, W, 3) float32 in [-1, 1], resized bilinearly with PIL."""
    from PIL import Image

    img = Image.open(path).convert("RGB").resize((hw[1], hw[0]), Image.BILINEAR)
    return np.asarray(img, np.float32) / 127.5 - 1.0


def frame_batches(clips: Dict[str, List[str]], hw, batch: int) -> Iterator[np.ndarray]:
    """Every frame of every clip, ``batch`` at a time, (N, H, W, 3)."""
    out = []
    for frames in clips.values():
        for f in frames:
            out.append(load_image(f, hw))
            if len(out) == batch:
                yield np.stack(out)
                out = []
    if out:
        yield np.stack(out)


def clip_batches(clips: Dict[str, List[str]], hw) -> Iterator[np.ndarray]:
    """Whole clips, ``CLIPS_PER_BATCH`` at a time, (N, T, H, W, 3)."""
    out = []
    for frames in clips.values():
        out.append(np.stack([load_image(f, hw) for f in frames]))
        if len(out) == CLIPS_PER_BATCH:
            yield np.stack(out)
            out = []
    if out:
        yield np.stack(out)


def load_tower(model, path: str, name: str) -> None:
    """A torch state dict into ``model`` under its own names, strictly once
    the names outside the feature tower are dropped; the counts go to stderr."""
    from panacea_tpu_torch.checkpoint import load_torch_checkpoint

    sd = load_torch_checkpoint(path)
    keep = {k: v for k, v in sd.items()
            if not (k.startswith(DROPPED_PREFIXES) or k.endswith(DROPPED_SUFFIX))}
    missing = sorted(set(model.state_dict()) - set(keep))
    if missing:
        raise KeyError(f"{path}: {len(missing)} {name} tensors missing, e.g. {missing[:4]}")
    model.load_state_dict(keep, strict=True)
    print(f"[{name}] restore: 0 missing, {len(sd) - len(keep)} dropped "
          f"(AuxLogits/fc/num_batches_tracked)", file=sys.stderr)


def build_towers(device, inception_ckpt: Optional[str] = None,
                 i3d_ckpt: Optional[str] = None, seed: int = 0):
    """(InceptionV3, I3D) on ``device`` in eval mode: random from ``seed``
    (convolutions He-normal, batch-norm statistics drawn), then the given
    checkpoints loaded over them."""
    import torch

    from panacea_tpu_torch.metrics_gen.i3d import I3D
    from panacea_tpu_torch.metrics_gen.inception import InceptionV3

    gen = torch.Generator(device=device).manual_seed(seed)
    towers = []
    for cls, ckpt, name in ((InceptionV3, inception_ckpt, "inception"),
                            (I3D, i3d_ckpt, "i3d")):
        model = cls().to(device).eval()
        init_random(model, gen)
        if ckpt:
            load_tower(model, ckpt, name)
        towers.append(model)
    return tuple(towers)


def init_random(model, generator) -> None:
    """Every tensor drawn from ``generator``: convolution weights He-normal,
    batch-norm scales 1 + N(0, 0.1^2), running variances uniform in [0.5, 2),
    the other vectors N(0, 0.1^2)."""
    import torch

    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith("running_var"):
                t.copy_(torch.rand(t.shape, generator=generator, device=t.device) * 1.5 + 0.5)
            elif name.endswith("bn.weight"):
                t.copy_(torch.randn(t.shape, generator=generator, device=t.device) * 0.1 + 1.0)
            elif t.ndim > 1:
                std = (2.0 / t[0].numel()) ** 0.5
                t.copy_(torch.randn(t.shape, generator=generator, device=t.device) * std)
            else:
                t.copy_(torch.randn(t.shape, generator=generator, device=t.device) * 0.1)


def features(model, batches: Iterator[np.ndarray], device) -> Iterator:
    """Channels-last numpy batches -> the tower's features on ``device``."""
    import torch

    for xb in batches:
        x = torch.as_tensor(xb, device=device)
        x = x.permute(0, 3, 1, 2) if x.ndim == 4 else x.permute(0, 4, 1, 2, 3)
        with torch.inference_mode():
            yield model(x.contiguous())


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    """Run the CLI on ``argv`` (default ``sys.argv[1:]``); returns what it
    printed, unrounded."""
    args = get_parser().parse_args(argv)
    # honesty guard: random towers give numbers that could be mistaken for a
    # result; refuse unless explicitly allowed, and stamp the JSON then
    towers_random = not (args.inception_ckpt and args.i3d_ckpt)
    if not args.synthetic and towers_random and not args.allow_random_towers:
        sys.exit(
            "eval_generation: refusing to compute FID/FVD with random-init "
            "feature towers (no --inception_ckpt/--i3d_ckpt). These numbers "
            "would be meaningless. Pass converted tower weights, or "
            "--allow_random_towers for a pipeline smoke run (output will be "
            "stamped 'towers': 'random-init').")

    from panacea_tpu_torch.metrics_gen.fid import compute_fid, compute_fvd
    from panacea_tpu_torch.models.engine import no_tf32, resolve_device

    device = resolve_device(args.device)  # raises without a card unless told otherwise
    towers = "random-init" if towers_random else "converted"
    with no_tf32():
        inception, i3d = build_towers(device, args.inception_ckpt, args.i3d_ckpt)
        if args.synthetic:
            rs = np.random.RandomState(0)

            def synth(n, shape):
                for _ in range(n):
                    yield rs.uniform(-1, 1, shape).astype(np.float32)

            frames = (args.batch,) + INCEPTION_HW + (3,)
            clips = (CLIPS_PER_BATCH, args.num_frames) + I3D_HW + (3,)
            fid = compute_fid(features(inception, synth(2, frames), device),
                              features(inception, synth(2, frames), device))
            fvd = compute_fvd(features(i3d, synth(2, clips), device),
                              features(i3d, synth(2, clips), device))
            print(f'{{"fid": {fid:.4f}, "fvd": {fvd:.4f}, "synthetic": true, '
                  f'"towers": "{towers}"}}')
            return {"fid": fid, "fvd": fvd, "synthetic": True, "towers": towers}

        if not (args.real_root and args.gen_root):
            raise SystemExit("--real_root/--gen_root required")
        real = collect_clips(args.real_root, args.num_frames)
        gen = collect_clips(args.gen_root, args.num_frames)
        if args.max_clips:
            real = dict(list(real.items())[: args.max_clips])
            gen = dict(list(gen.items())[: args.max_clips])
        print(f"[eval_generation] {len(real)} real / {len(gen)} gen clips", file=sys.stderr)
        fid = compute_fid(features(inception, frame_batches(real, INCEPTION_HW, args.batch),
                                   device),
                          features(inception, frame_batches(gen, INCEPTION_HW, args.batch),
                                   device))
        fvd = compute_fvd(features(i3d, clip_batches(real, I3D_HW), device),
                          features(i3d, clip_batches(gen, I3D_HW), device))
    print(f'{{"fid": {fid:.4f}, "fvd": {fvd:.4f}, '
          f'"real_clips": {len(real)}, "gen_clips": {len(gen)}, '
          f'"towers": "{towers}"}}')
    return {"fid": fid, "fvd": fvd, "real_clips": len(real), "gen_clips": len(gen),
            "towers": towers}
