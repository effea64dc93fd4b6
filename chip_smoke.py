#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``panacea_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py             # every phase
    python3 chip_smoke.py --kernels   # phases 1 and 2 only

Phases, in order; any failure exits non-zero:
  1. build: compile the port's CUDA kernels from ``panacea_tpu_torch/csrc``
     with nvcc (one process per source, started together) and its rasterizer
     with g++; an ignored ``setmaxnreg`` in the ptxas report is a failure;
  2. kernels: each kernel at every shape the generation path gives it and at
     ragged and tiny shapes, held against its plain PyTorch version on the
     same inputs (per element, the rule of
     ``panacea_tpu_torch/ops/tolerance.py``), and timed beside the plain
     version, a one-call PyTorch yardstick and its bound: the bf16 kernels
     (tensor cores), then the fp32 kernels (FMA units, TF32 off everywhere);
  3. small input: the tiny engine on the card (bf16, kernels) against the
     same weights on the CPU (fp32, plain versions), two sampler steps;
  4. log_images: ``DiffusionEngine3D.log_images`` called directly at full
     production width (INFERENCE_NUSCENES: 6 views x 8 frames, 256 x 3072
     images, CFG batch of 16 frames) on random arrays, 5 steps, random
     weights from a seed; 21 flash and 69 GEGLU launches per network
     evaluation; one step under torch.profiler;
  5. CLI: ``panacea_tpu_torch.inference.main`` in process, ``--synthetic
     --num_batches 1`` at full width and 25 steps: the dataset with the BEV
     rendering on the host, the copy to the card, ``log_images``, the
     writers; the files that came out are checked, the launch counters must
     rise by 525 and 1,725, and the clip's split is printed;
  6. rollout: the CLI with ``--rollout 2 --num_steps 4``: 15 frames stitched,
     the second window conditioned on the first one's last frame;
  7. fp32 engine: the production engine in fp32 and in bf16 with the same
     weights and the same injected noise, two sampler steps each; the fp32
     launch counters must rise by 42 and 138, and the latents' relative
     difference after each step is printed.

The last three lines of standard output are the ``{"kernels": [...]}``
summary, the card's name and power limit as nvidia-smi reports them, and
``{"ok": true, "device": {...}}``. Without a CUDA device, or outside the
repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import tempfile
import time

SEED = 0
# random weights: the parameters the model zero-initialises get this std, so
# every branch computes while the output stays in a trained model's range
ZERO_INIT_STD = 0.02
MAIN_STEPS = 25        # the production sampler's step count (the CLI phase)
DIRECT_STEPS = 5       # the direct log_images phase: s/step and the profiled step
ROLLOUT_WINDOWS, ROLLOUT_STEPS = 2, 4
FP32_STEPS = 2
CLI_SEED = 23          # the CLI's default seed
PEAK_BF16 = 989e12     # H100 SXM dense bf16 flop/s (NVIDIA data sheet)
PEAK_FP32 = 67e12      # H100 SXM fp32 flop/s outside the tensor cores (same data sheet)
PEAK_BYTES = 3.35e12   # H100 SXM HBM3 bytes/s
SMALL_TOL = 5e-2       # tiny engine, bf16 card vs fp32 CPU, relative to the latent's scale
FLASH_PER_EVAL, GEGLU_PER_EVAL = 21, 69


def log(obj) -> None:
    print(obj if isinstance(obj, str) else json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_us(torch, fn, iters: int) -> float:
    """Host time of one call, not waiting for the card: checks, tensor-map
    specs and their encoding, and the launch."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / iters * 1e6


def bound(flops: float, nbytes: float, peak: float = PEAK_BF16):
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def check_flash(torch, F, fa, tol, dev, b, sq, skv, h, d, ragged=False, merged_kv=False,
                timed=True, lens=None, fp32=False):
    """``merged_kv``: k and v are the two halves of one (B, Skv, 2 H D)
    projection, the strided layout the cross-view call gives the kernel.
    ``ragged`` draws the rows' key counts; ``lens`` gives them. ``fp32``:
    fp32 operands (the fp32 kernel, held to ``tol.FLASH_F32`` and bounded by
    the fp32 FMA rate); TF32 is off for the plain version and the yardstick."""
    dtype, rule = (torch.float32, tol.FLASH_F32) if fp32 else (torch.bfloat16, tol.FLASH)
    elem = 4.0 if fp32 else 2.0
    g = torch.Generator(device=dev).manual_seed(sq * 7 + skv + d)
    q = torch.randn((b, sq, h, d), generator=g, device=dev).to(dtype)
    if merged_kv:
        kv = torch.randn((b, skv, 2 * h * d), generator=g, device=dev).to(dtype)
        k, v = (t.unflatten(-1, (h, d)) for t in kv.chunk(2, dim=-1))
    else:
        k = torch.randn((b, skv, h, d), generator=g, device=dev).to(dtype)
        v = torch.randn((b, skv, h, d), generator=g, device=dev).to(dtype)
    if lens is not None:
        ragged = True
        lens = torch.tensor(lens, device=dev, dtype=torch.int32)
    elif ragged:
        lens = torch.randint(1, skv + 1, (b,), generator=g, device=dev, dtype=torch.int32)
    routes = dict(fa.flash_attention.route_launches)
    got = fa.flash_attention(q, k, v, kv_lens=lens)
    route = next(r for r, n in fa.flash_attention.route_launches.items() if n != routes[r])
    want = fa.flash_attention_plain(q, k, v, kv_lens=lens)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    ratio = tol.worst_ratio(got, want, **rule)
    rec = {"kernel": "flash_attention", "route": route, "dtype": str(dtype),
           "shape": {"B": b, "Sq": sq, "Skv": skv, "H": h, "D": d, "ragged": ragged,
                     "kv": "merged" if merged_kv else "contiguous"},
           "max_abs_err": err, "rms_want": want.float().square().mean().sqrt().item(),
           "worst_ratio": ratio, "tol": rule}
    if timed:
        mask = None
        if lens is not None:
            mask = (torch.arange(skv, device=dev)[None] < lens[:, None])[:, None, None, :]
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        kv_eff = float(lens.sum().item()) / b if lens is not None else skv  # keys the rows need
        flops = 4.0 * b * h * sq * kv_eff * d
        nbytes = elem * (2 * b * sq * h * d + 2 * b * kv_eff * h * d) + (4 * b if ragged else 0)
        rec["bound_ms"], rec["bound_by"] = bound(flops, nbytes, PEAK_FP32 if fp32 else PEAK_BF16)
        rec["ms"] = time_ms(torch, lambda: fa.flash_attention(q, k, v, kv_lens=lens),
                            5 if fp32 else 20)
        rec["plain_ms"] = time_ms(
            torch, lambda: fa.flash_attention_plain(q, k, v, kv_lens=lens), 2)
        rec["library_ms"] = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask), 5 if fp32 else 20)
        rec["host_us"] = host_us(torch, lambda: fa.flash_attention(q, k, v, kv_lens=lens), 50)
    log(rec)
    if not ratio <= 1.0:
        raise AssertionError(f"flash_attention disagrees with its plain version: {rec}")
    return rec


def check_geglu(torch, F, gg, tol, dev, tokens, c, timed=True, inner=None, fp32=False):
    """``fp32``: fp32 operands (the fp32 kernel, ``tol.GEGLU_F32``, the fp32
    FMA rate as the bound); TF32 is off for the plain version and the
    yardstick."""
    dtype, rule = (torch.float32, tol.GEGLU_F32) if fp32 else (torch.bfloat16, tol.GEGLU)
    inner = 4 * c if inner is None else inner
    g = torch.Generator(device=dev).manual_seed(tokens + c)
    x = torch.randn((tokens, c), generator=g, device=dev).to(dtype)
    w = (torch.randn((2 * inner, c), generator=g, device=dev) * c**-0.5).to(dtype)
    b = (torch.randn(2 * inner, generator=g, device=dev) * 0.1).to(dtype)
    routes = dict(gg.geglu.route_launches)
    got = gg.geglu(x, w, b)
    route = next(r for r, n in gg.geglu.route_launches.items() if n != routes[r])
    want = gg.geglu_plain(x, w, b)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    ratio = tol.worst_ratio(got, want, **rule)
    rec = {"kernel": "geglu", "route": route, "dtype": str(dtype),
           "shape": {"tokens": tokens, "C": c, "inner": inner},
           "max_abs_err": err, "rms_want": want.float().square().mean().sqrt().item(),
           "worst_ratio": ratio, "tol": rule}
    if timed:
        flops = 4.0 * tokens * c * inner
        nbytes = (4.0 if fp32 else 2.0) * (tokens * c + 2 * inner * c + 2 * inner + tokens * inner)
        rec["bound_ms"], rec["bound_by"] = bound(flops, nbytes, PEAK_FP32 if fp32 else PEAK_BF16)
        rec["ms"] = time_ms(torch, lambda: gg.geglu(x, w, b), 5 if fp32 else 20)
        rec["plain_ms"] = time_ms(torch, lambda: gg.geglu_plain(x, w, b), 3)
        rec["library_ms"] = time_ms(torch, lambda: F.linear(x, w, b), 20)

        def unfused():  # the whole function in PyTorch calls, in the operands' type
            hh, gate = F.linear(x, w, b).chunk(2, dim=-1)
            return hh * F.gelu(gate)

        rec["unfused_ms"] = time_ms(torch, unfused, 20)
        rec["host_us"] = host_us(torch, lambda: gg.geglu(x, w, b), 50)
    log(rec)
    if not ratio <= 1.0:
        raise AssertionError(f"geglu disagrees with its plain version: {rec}")
    return rec


def small_input_agreement(torch, np, dev):
    """Tiny engine: card (bf16, CUDA kernels) vs CPU (fp32, plain versions)."""
    from panacea_tpu_torch.configs import TINY_CPU
    from panacea_tpu_torch.registry import instantiate_from_config

    t, lh, lw, ih, iw = 2, 8, 96, 64, 768   # 128 tokens per view: the flash route
    cpu = instantiate_from_config(TINY_CPU["model"], device="cpu")
    cpu.init_weights(torch.Generator().manual_seed(SEED), zero_init_std=ZERO_INIT_STD)
    card = instantiate_from_config(TINY_CPU["model"], device=dev)
    card.load_state_dict(cpu.state_dict(), strict=True)
    rng = np.random.default_rng(SEED)
    cond = {"crossattn": rng.standard_normal((1, 77, 64)),
            "concat": rng.standard_normal((t, lh, lw, 4)) * 0.5,
            "cond_feat": rng.uniform(0, 1, (t, ih, iw, 19))}
    uc = dict(cond, crossattn=np.zeros((1, 77, 64)))
    noise = rng.standard_normal((t, lh, lw, 4))
    out = []
    for eng in (cpu, card):
        def tens(c):
            return {k: torch.as_tensor(v, dtype=torch.float32, device=eng.device)
                    for k, v in c.items()}
        z = eng.sample(tens(cond), uc=tens(uc), batch_size=t, shape=(lh, lw, 4),
                       noise=torch.as_tensor(noise, dtype=torch.float32), num_steps=2)
        out.append(z.float().cpu())
    ref, got = out
    rel = ((got - ref).abs().max() / ref.abs().max()).item()
    rec = {"phase": "small_input", "config": "TINY_CPU", "latent": [t, lh, lw, 4],
           "steps": 2, "max_rel_err": rel, "tol": SMALL_TOL,
           "finite": bool(torch.isfinite(got).all())}
    log(rec)
    if not (rec["finite"] and rel <= SMALL_TOL):
        raise AssertionError(f"tiny engine on the card disagrees with the CPU: {rec}")


def reset_counts(fa, gg) -> None:
    fa.flash_attention.launches = gg.geglu.launches = 0
    for counts in (fa.flash_attention.route_launches, gg.geglu.route_launches):
        counts.update(dict.fromkeys(counts, 0))


def read_counts(fa, gg) -> dict:
    return {"flash_attention": fa.flash_attention.launches, "geglu": gg.geglu.launches,
            "flash_routes": dict(fa.flash_attention.route_launches),
            "geglu_routes": dict(gg.geglu.route_launches)}


def free(torch) -> None:
    gc.collect()
    torch.cuda.empty_cache()


def main_path(torch, np, dev, fa, gg, steps: int, card: str):
    """``log_images`` called directly on random arrays (no dataset, no
    writers): s/step, the launch counts and one profiled step."""
    from panacea_tpu_torch.configs import INFERENCE_NUSCENES
    from panacea_tpu_torch.registry import instantiate_from_config

    t0 = time.perf_counter()
    eng = instantiate_from_config(INFERENCE_NUSCENES["model"], device=dev)
    eng.init_weights(torch.Generator(device=dev).manual_seed(SEED), zero_init_std=ZERO_INIT_STD)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in eng.parameters())
    rng = np.random.default_rng(SEED)
    t, ih, iw = eng.num_frames, 256, 3072
    jpg = rng.uniform(-1, 1, (1, t, ih, iw, 3)).astype(np.float32)
    fcz = np.zeros_like(jpg)
    fcz[:, -1] = jpg[:, -1]   # use_last_frame conditioning
    batch = {"jpg": jpg, "cond_img": rng.uniform(0, 1, (1, t, ih, iw, 19)).astype(np.float32),
             "final_cond_zero": fcz, "txt": ["a driving scene. daytime. sunny."]}

    step_s = []
    last_call = []
    network_fn = eng.network_fn

    def timed_network(*a, **kw):
        s = time.perf_counter()
        out = network_fn(*a, **kw)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - s)
        last_call[:] = [a, kw]
        return out

    eng.network_fn = timed_network

    # what log_images does outside the steps, each call between two synchronisations
    outside = {}

    def timed(name, fn):
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            s = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            entry = outside.setdefault(name, {"seconds": 0.0, "calls": 0})
            entry["seconds"] += time.perf_counter() - s
            entry["calls"] += 1
            return out
        return wrapper

    eng.encode_first_stage = timed("vae_encode_8_frames", eng.encode_first_stage)
    eng.decode_first_stage = timed("vae_decode_8_frames", eng.decode_first_stage)
    net = eng.model.diffusion_model
    net.encode_hint = timed("controlnet_hint_stack", net.encode_hint)
    for emb in eng.conditioner.embedders:
        if getattr(emb, "encode_fn", None) is not None:
            emb.encode_fn = eng.encode_first_stage
        elif hasattr(emb, "tokenizer"):
            emb.forward = timed("text_tower", emb.forward)
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fa, gg)
    t0 = time.perf_counter()
    logd = eng.log_images(batch, N=1, generator=torch.Generator(device=dev).manual_seed(SEED),
                          num_steps=steps)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    counts = read_counts(fa, gg)
    launches = {k: counts[k] for k in ("flash_attention", "geglu")}

    shapes = {"inputs": (t, ih, iw, 3), "reconstructions": (t, ih, iw, 3),
              "samples": (t, ih, iw, 3), "control": (t, ih, iw, 19)}
    finite = {k: bool(torch.isfinite(logd[k]).all()) for k in shapes}
    ok_shape = {k: tuple(logd[k].shape) == s for k, s in shapes.items()}
    steady = sorted(step_s[1:] or step_s)[len(step_s[1:] or step_s) // 2]
    rec = {"phase": "log_images", "card": card, "params": n_params,
           "dtype": str(eng.dtype), "steps": steps, "setup_s": setup_s,
           "log_images_s": total_s, "step_s": step_s, "s_per_step": steady,
           "s_per_clip_25_steps": total_s - sum(step_s) + 25 * steady,
           "outside_steps_s": total_s - sum(step_s), "outside_steps": outside,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": launches, "flash_routes": dict(fa.flash_attention.route_launches),
           "expected": {"flash_attention": FLASH_PER_EVAL * steps, "geglu": GEGLU_PER_EVAL * steps},
           "finite": finite, "shapes_ok": ok_shape,
           "sample_abs_mean": logd["samples"].abs().mean().item()}
    log(rec)
    if not (all(finite.values()) and all(ok_shape.values())):
        raise AssertionError(f"main path output is wrong: {rec}")
    if launches != rec["expected"]:
        raise AssertionError(f"kernel launches {launches} != expected {rec['expected']}")
    if rec["flash_routes"]["wgmma"] != launches["flash_attention"]:
        raise AssertionError(f"the main path (head dim 64) left the wgmma route: {rec}")
    profile_step(torch, lambda: network_fn(*last_call[0], **last_call[1]))
    return counts


def tree_of(root: str):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, names in os.walk(root) for f in names)


def image_info(path: str):
    """(width, height, frames, pixel standard deviation of the first frame)."""
    import numpy as np
    from PIL import Image

    with Image.open(path) as im:
        frames = getattr(im, "n_frames", 1)
        first = np.asarray(im.convert("RGB"), dtype=np.float32)
        return im.size[0], im.size[1], frames, float(first.std())


def cli_phase(torch, np, dev, fa, gg, card: str):
    """The inference CLI at full width, one synthetic clip, 25 steps."""
    from panacea_tpu_torch import inference
    from panacea_tpu_torch.data.nuscenes.dataset import PANORAMA_VIEWS

    copies = {"seconds": 0.0, "bytes": 0, "calls": 0}
    as_tensor = torch.as_tensor

    def timed_as_tensor(data, *a, **kw):
        # the host-to-card copies of the batch (numpy arrays of a megabyte and
        # more), each timed between two synchronisations
        if not isinstance(data, np.ndarray) or data.nbytes < 1 << 20:
            return as_tensor(data, *a, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = as_tensor(data, *a, **kw)
        if out.is_cuda:
            torch.cuda.synchronize()
            copies["seconds"] += time.perf_counter() - t0
            copies["bytes"] += data.nbytes
            copies["calls"] += 1
        return out

    # the writers' three parts, timed on the host clock inside log_outputs
    from panacea_tpu_torch import writers

    parts = {"save_image_grid": 0.0, "save_gif": 0.0, "save_frames_gen_nuscenes": 0.0}
    real_writers = {name: getattr(writers, name) for name in parts}

    def timed_writer(name):
        def wrapper(*a, **kw):
            t0 = time.perf_counter()
            try:
                return real_writers[name](*a, **kw)
            finally:
                parts[name] += time.perf_counter() - t0
        return wrapper

    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.reset_peak_memory_stats()
        reset_counts(fa, gg)
        torch.as_tensor = timed_as_tensor
        for name in parts:
            setattr(writers, name, timed_writer(name))
        t0 = time.perf_counter()
        try:
            out = inference.main(["--synthetic", "--num_batches", "1", "--outdir", tmp,
                                  "--name", "smoke", "--seed", str(CLI_SEED)])
        finally:
            torch.as_tensor = as_tensor
            for name, fn in real_writers.items():
                setattr(writers, name, fn)
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t0
        counts = read_counts(fa, gg)
        tree = tree_of(out["outdir"])
        t = 8
        stem = f"synth__CAM_FRONT__{t - 1:012d}"
        want = [f"{key}/{stem}.{ext}" for key in ("control", "inputs", "samples")
                for ext in ("gif", "png")]
        want += [f"gen-nuscenes/{cam}_synth__{cam}__{t - 1:012d}/_{i:06d}.jpg"
                 for cam in PANORAMA_VIEWS for i in range(t)]
        sizes = {"jpg": image_info(os.path.join(out["outdir"], want[-1])),
                 "png": image_info(os.path.join(out["outdir"], "samples", stem + ".png")),
                 "gif": image_info(os.path.join(out["outdir"], "samples", stem + ".gif"))}
        jpg_ok = all(image_info(os.path.join(out["outdir"], rel))[:3] == (512, 256, 1)
                     for rel in want if rel.endswith(".jpg"))
    tm = out["timer"].totals
    clip_wall = tm["dataset"] + tm["clip"] + tm["to_host"] + tm["write"]
    waited = tm["dataset"] + copies["seconds"] + tm["to_host"] + tm["write"]
    rec = {"phase": "cli", "card": card, "steps": MAIN_STEPS, "main_s": main_s,
           "clip": {"dataset_s": tm["dataset"], "copy_to_card_s": copies["seconds"],
                    "copy_to_card_gb": copies["bytes"] / 1e9, "copy_calls": copies["calls"],
                    "log_images_s": tm["clip"], "to_host_s": tm["to_host"],
                    "writers_s": tm["write"], "writers_split_s": parts, "wall_s": clip_wall,
                    # dataset, copies in both directions and writers: the card
                    # has no work then (the idle share inside the steps is the
                    # profiled step's)
                    "card_waited_for_host_share": waited / clip_wall},
           "outside_clip_s": main_s - clip_wall,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": counts, "files": len(tree), "sizes": sizes}
    log(rec)
    if tree != sorted(want):
        raise AssertionError(f"the CLI wrote {tree}, expected {sorted(want)}")
    if not (jpg_ok and sizes["png"][:3] == (3072, 8 * 256, 1) and sizes["gif"][:3] == (3072, 256, 8)):
        raise AssertionError(f"the CLI's images have the wrong sizes: {sizes}")
    if not all(v[3] > 1.0 for v in sizes.values()):
        raise AssertionError(f"the CLI's sample images are blank: {sizes}")
    expected = {"flash_attention": FLASH_PER_EVAL * MAIN_STEPS, "geglu": GEGLU_PER_EVAL * MAIN_STEPS}
    if {k: counts[k] for k in expected} != expected:
        raise AssertionError(f"CLI kernel launches {counts} != expected {expected}")
    if counts["flash_routes"]["wgmma"] != expected["flash_attention"]:
        raise AssertionError(f"the CLI (head dim 64, bf16) left the wgmma route: {counts}")
    return counts


def rollout_phase(torch, np, dev, fa, gg, card: str):
    """``--rollout 2 --num_steps 4`` at full width through the CLI."""
    from panacea_tpu_torch import inference
    from panacea_tpu_torch.models.engine import DiffusionEngine3D

    calls = []
    log_images = DiffusionEngine3D.log_images

    def recording(self, batch, *a, **kw):
        out = log_images(self, batch, *a, **kw)
        calls.append({"fcz": np.array(batch["final_cond_zero"][0]),
                      "share_noise_frame": kw.get("share_noise_frame"),
                      "last": out["samples"][-1].float().cpu().numpy()})
        return out

    frames = ROLLOUT_WINDOWS * 8 - (ROLLOUT_WINDOWS - 1)
    with tempfile.TemporaryDirectory() as tmp:
        reset_counts(fa, gg)
        DiffusionEngine3D.log_images = recording
        t0 = time.perf_counter()
        try:
            out = inference.main(["--synthetic", "--num_batches", "1", "--outdir", tmp,
                                  "--name", "smoke", "--seed", str(CLI_SEED),
                                  "--rollout", str(ROLLOUT_WINDOWS),
                                  "--num_steps", str(ROLLOUT_STEPS)])
        finally:
            DiffusionEngine3D.log_images = log_images
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t0
        counts = read_counts(fa, gg)
        tree = tree_of(out["outdir"])
        stem = f"synth__CAM_FRONT__{2 * 8 - 2:012d}"     # the second window's last frame
        want = sorted([f"rollout/{stem}/frame_{i:04d}.jpg" for i in range(frames)]
                      + [f"rollout/{stem}/long.gif"])
        gif = image_info(os.path.join(out["outdir"], "rollout", stem, "long.gif"))
        jpg = image_info(os.path.join(out["outdir"], "rollout", stem, f"frame_{frames - 1:04d}.jpg"))
    tm = out["timer"].totals
    evals = ROLLOUT_WINDOWS * ROLLOUT_STEPS
    rec = {"phase": "rollout", "card": card, "windows": ROLLOUT_WINDOWS, "steps": ROLLOUT_STEPS,
           "frames": frames, "main_s": main_s, "rollout_s": tm["rollout"],
           "writers_s": tm["write"], "launches": counts, "gif": gif, "jpg": jpg,
           "share_noise_frame": [c["share_noise_frame"] for c in calls]}
    log(rec)
    if tree != want:
        raise AssertionError(f"the rollout wrote {tree}, expected {want}")
    if gif[:3] != (3072, 256, frames) or jpg[:3] != (3072, 256, 1) or not jpg[3] > 1.0:
        raise AssertionError(f"the rollout's images are wrong: {rec}")
    if len(calls) != ROLLOUT_WINDOWS or rec["share_noise_frame"] != [-1, 0]:
        raise AssertionError(f"the rollout's windows are wrong: {rec['share_noise_frame']}")
    second = calls[1]["fcz"]
    if not (np.array_equal(second[0], calls[0]["last"]) and not second[1:].any()):
        raise AssertionError("the second window is not conditioned on the first one's last frame")
    if (counts["flash_attention"], counts["geglu"]) != (FLASH_PER_EVAL * evals, GEGLU_PER_EVAL * evals):
        raise AssertionError(f"rollout kernel launches {counts}")
    return counts


def fp32_engine_phase(torch, np, dev, fa, gg, card: str):
    """The production engine in fp32 and in bf16, the same weights (drawn in
    bf16, so both hold the same numbers) and the same injected noise."""
    from panacea_tpu_torch.configs import INFERENCE_NUSCENES
    from panacea_tpu_torch.registry import instantiate_from_config

    t, lh, lw, ih, iw = 8, 32, 384, 256, 3072
    rng = np.random.default_rng(SEED)
    cond = {"crossattn": rng.standard_normal((1, 77, 1024)),
            "concat": rng.standard_normal((t, lh, lw, 4)) * 0.5,
            "cond_feat": rng.uniform(0, 1, (t, ih, iw, 19))}
    uc = dict(cond, crossattn=np.zeros((1, 77, 1024)))
    noise = torch.as_tensor(rng.standard_normal((t, lh, lw, 4)), dtype=torch.float32)

    def run(eng):
        def tens(c):
            return {k: torch.as_tensor(v, dtype=torch.float32, device=dev) for k, v in c.items()}
        c, u = tens(cond), tens(uc)
        torch.cuda.reset_peak_memory_stats()
        reset_counts(fa, gg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, traj = eng.sample(c, uc=u, batch_size=t, shape=(lh, lw, 4), noise=noise,
                             num_steps=FP32_STEPS, return_trajectory=True)
        torch.cuda.synchronize()
        return (traj.float().cpu(), time.perf_counter() - t0, read_counts(fa, gg),
                torch.cuda.max_memory_allocated() / 1e9)

    eng16 = instantiate_from_config(INFERENCE_NUSCENES["model"], device=dev)
    eng16.init_weights(torch.Generator(device=dev).manual_seed(SEED), zero_init_std=ZERO_INIT_STD)
    traj16, s16, counts16, mem16 = run(eng16)
    eng32 = instantiate_from_config(INFERENCE_NUSCENES["model"], device=dev, dtype=torch.float32)
    eng32.load_state_dict(eng16.state_dict(), strict=True)
    del eng16
    free(torch)
    traj32, s32, counts32, mem32 = run(eng32)
    del eng32
    free(torch)

    drift = []
    for i in range(FP32_STEPS):
        d, ref = traj16[i] - traj32[i], traj32[i]
        drift.append({"step": i + 1, "max_rel": (d.abs().max() / ref.abs().max()).item(),
                      "rms_rel": (d.square().mean().sqrt() / ref.square().mean().sqrt()).item()})
    expected = {"flash": FLASH_PER_EVAL * FP32_STEPS, "geglu": GEGLU_PER_EVAL * FP32_STEPS}
    rec = {"phase": "fp32_engine", "card": card, "steps": FP32_STEPS, "drift_bf16_vs_fp32": drift,
           "fp32": {"sample_s": s32, "s_per_step": s32 / FP32_STEPS, "peak_mem_gb": mem32,
                    "launches": counts32},
           "bf16": {"sample_s": s16, "s_per_step": s16 / FP32_STEPS, "peak_mem_gb": mem16,
                    "launches": counts16},
           "finite": bool(torch.isfinite(traj32).all() and torch.isfinite(traj16).all())}
    log(rec)
    if not rec["finite"]:
        raise AssertionError(f"non-finite latents: {rec}")
    if (counts32["flash_routes"]["fp32"], counts32["geglu_routes"]["fp32"]) != (
            expected["flash"], expected["geglu"]):
        raise AssertionError(f"the fp32 engine's launches {counts32} != {expected} on the fp32 routes")
    if counts32["flash_attention"] != expected["flash"] or counts32["geglu"] != expected["geglu"]:
        raise AssertionError(f"the fp32 engine launched a kernel of another type: {counts32}")
    if (counts16["flash_routes"]["wgmma"], counts16["geglu_routes"]["bf16"]) != (
            expected["flash"], expected["geglu"]):
        raise AssertionError(f"the bf16 engine's launches {counts16} != {expected}")
    return counts32


# the port's kernels by their own symbols: PyTorch's SDPA has a flash_fwd_kernel too
BUCKETS = (("flash_attention", ("pn_flash_",)), ("geglu", ("pn_geglu_fwd",)),
           ("sdpa", ("fmha", "flash", "attention", "softmax")),
           ("conv", ("conv", "cudnn", "implicit", "dgrad", "wgrad", "nhwc")),
           ("matmul", ("gemm", "xmma", "cutlass", "gemv", "matmul", "sm90")),
           ("norm_reduce", ("reduce", "norm", "welford")),
           ("elementwise", ("elementwise", "vectorized", "unrolled", "copy", "cat")))


def profile_step(torch, step):
    """One network evaluation of the main path under torch.profiler: device
    time per kernel bucket and the device's idle share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad():
        step()
    torch.cuda.synchronize()
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    buckets, other, total = {}, {}, 0.0
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", 0.0) or 0.0
        if us <= 0 or not str(evt.device_type).endswith("CUDA"):
            continue  # host ops carry their kernels' time too: count kernels only
        name = evt.key.lower()
        bucket = next((b for b, keys in BUCKETS if any(k in name for k in keys)), "other")
        buckets[bucket] = buckets.get(bucket, 0.0) + us / 1e3
        if bucket == "other":
            other[evt.key] = other.get(evt.key, 0.0) + us / 1e3
        total += us / 1e3
    rec = {"phase": "profile_step", "wall_ms": wall_ms,
           "device_ms": total if total > 0 else "not measured",
           "idle_share": 1 - total / wall_ms if total > 0 else "not measured",
           "bucket_ms": dict(sorted(buckets.items(), key=lambda kv: -kv[1]))}
    log(rec)
    log({"phase": "profile_other", "top10_ms": [
        [name[:120], ms] for name, ms in sorted(other.items(), key=lambda kv: -kv[1])[:10]]})


def main(kernels_only: bool = False) -> int:
    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from panacea_tpu_torch.ops import _build
        from panacea_tpu_torch.ops import flash_attention as fa
        from panacea_tpu_torch.ops import geglu as gg
        from panacea_tpu_torch.ops import tolerance as tol
    except ImportError as e:
        print(f"chip_smoke: the port package is not beside this script ({e})", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    # fp32 matrix products of the plain versions and yardsticks in full fp32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log({"phase": "env", "torch": torch.__version__, "cuda": torch.version.cuda,
         "python": sys.version.split()[0], "card": card,
         "device": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()})

    t0 = time.perf_counter()
    _build.build_all()
    nvcc_s = time.perf_counter() - t0
    from panacea_tpu_torch import native

    native.get_lib()   # the rasterizer of the dataset's BEV rendering, with g++
    log({"phase": "build", "seconds": time.perf_counter() - t0, "nvcc_seconds": nvcc_s})
    for src, text in _build.build_log.items():
        for line in text.splitlines():
            if ("registers" in line or "spill" in line or "warning" in line.lower()
                    or "(C7" in line):   # ptxas advisories: serialised or injected wgmma waits
                log(f"ptxas {src}: {line.strip()}")
        if "C7508" in text or "setmaxnreg ignored" in text:
            raise AssertionError(f"{src}: ptxas ignored setmaxnreg, so the consumer "
                                 "warpgroups do not get the producer's registers")

    b = 16 * 5   # CFG batch of 16 frames x views 0-4
    levels = ((2048, 4096, 5), (512, 1024, 10), (128, 256, 20))
    # the main path's layout (k, v halves of the merged kv projection); then
    # contiguous k, v at the same shapes, timed in the same run to compare
    flash = [check_flash(torch, F, fa, tol, dev, b, sq, skv, h, 64, merged_kv=True)
             for sq, skv, h in levels]
    flash += [check_flash(torch, F, fa, tol, dev, b, sq, skv, h, 64)
              for sq, skv, h in levels]
    flash += [check_flash(torch, F, fa, tol, dev, b, 512, 1024, 10, 64, ragged=True),
              check_flash(torch, F, fa, tol, dev, 8, 300, 650, 5, 64),
              check_flash(torch, F, fa, tol, dev, 16, 100, 70, 3, 64, ragged=True, timed=False)]
    flash += [check_flash(torch, F, fa, tol, dev, 2, 256, 512, 2, d) for d in (16, 32, 128)]
    # tails of one row past a tile, a single key, one key past a tile edge,
    # and a batch whose rows all differ in length
    flash += [check_flash(torch, F, fa, tol, dev, 4, 129, 4097, 5, 64, timed=False),
              check_flash(torch, F, fa, tol, dev, 4, 256, 512, 5, 64, timed=False,
                          merged_kv=True, lens=[1, 129, 128, 512]),
              check_flash(torch, F, fa, tol, dev, 12, 200, 700, 2, 64, timed=False,
                          lens=[1 + 61 * i for i in range(12)])]
    for rec in flash:
        want = "wgmma" if rec["shape"]["D"] == 64 else "mma"
        if rec["route"] != want:
            raise AssertionError(f"flash_attention took route {rec['route']}, not {want}: {rec}")
    geglu = []
    for tokens, c in ((196608, 320), (49152, 640), (12288, 1280), (3072, 1280)):
        geglu.append(check_geglu(torch, F, gg, tol, dev, tokens, c))
        geglu.append(check_geglu(torch, F, gg, tol, dev, tokens + 77, c, timed=False))
    # channels off the 64-wide slice, columns off the 128-wide tile (also odd),
    # fewer tokens than one tile, and the tiny config's widths
    for tokens, c, inner in ((1000, 72, 288), (5000, 328, 1312), (300, 64, 200), (300, 64, 77),
                             (50, 320, 1280), (1, 64, 256), (256, 32, 128), (256, 64, 256)):
        geglu.append(check_geglu(torch, F, gg, tol, dev, tokens, c, timed=False, inner=inner))

    # the fp32 kernels at the same shapes: the three levels in both layouts,
    # the ragged case, the tails and the tiny widths
    flash32 = [check_flash(torch, F, fa, tol, dev, b, sq, skv, h, 64, merged_kv=True, fp32=True)
               for sq, skv, h in levels]
    flash32 += [check_flash(torch, F, fa, tol, dev, b, sq, skv, h, 64, fp32=True)
                for sq, skv, h in levels]
    flash32 += [check_flash(torch, F, fa, tol, dev, b, 512, 1024, 10, 64, ragged=True, fp32=True),
                check_flash(torch, F, fa, tol, dev, 16, 100, 70, 3, 64, ragged=True, timed=False,
                            fp32=True),
                check_flash(torch, F, fa, tol, dev, 4, 129, 4097, 5, 64, timed=False, fp32=True),
                check_flash(torch, F, fa, tol, dev, 4, 256, 512, 5, 64, timed=False, fp32=True,
                            merged_kv=True, lens=[1, 129, 128, 512]),
                check_flash(torch, F, fa, tol, dev, 12, 200, 700, 2, 64, timed=False, fp32=True,
                            lens=[1 + 61 * i for i in range(12)])]
    flash32 += [check_flash(torch, F, fa, tol, dev, 2, 256, 512, 2, d, timed=False, fp32=True)
                for d in (16, 32, 128)]
    geglu32 = []
    for tokens, c in ((196608, 320), (49152, 640), (12288, 1280), (3072, 1280)):
        geglu32.append(check_geglu(torch, F, gg, tol, dev, tokens, c, fp32=True))
        geglu32.append(check_geglu(torch, F, gg, tol, dev, tokens + 77, c, timed=False, fp32=True))
    # as above, and channels that are a multiple of 4 but not of 8
    for tokens, c, inner in ((1000, 72, 288), (5000, 328, 1312), (300, 64, 200), (300, 64, 77),
                             (50, 320, 1280), (1, 64, 256), (256, 32, 128), (256, 64, 256),
                             (100, 36, 100)):
        geglu32.append(check_geglu(torch, F, gg, tol, dev, tokens, c, timed=False, inner=inner,
                                   fp32=True))
    for rec in flash32 + geglu32:
        if rec["route"] != "fp32":
            raise AssertionError(f"fp32 operands took route {rec['route']}: {rec}")

    if kernels_only:
        log({"phase": "kernels_only", "ok": True})
        return 0
    small_input_agreement(torch, np, dev)
    paths = {"log_images": main_path(torch, np, dev, fa, gg, DIRECT_STEPS, card)}
    free(torch)
    paths["cli"] = cli_phase(torch, np, dev, fa, gg, card)
    free(torch)
    paths["rollout"] = rollout_phase(torch, np, dev, fa, gg, card)
    free(torch)
    paths["fp32_engine"] = fp32_engine_phase(torch, np, dev, fa, gg, card)

    def count(c, kernel, fp32):
        """Launches of one kernel on one type's routes, from a path's counts."""
        routes = c["flash_routes" if kernel == "flash_attention" else "geglu_routes"]
        return routes["fp32"] if fp32 else c[kernel] - routes["fp32"]

    def summary(name, kernel, source, replaces, recs, main, path):
        """``launches``: the count of the path that drives this kernel at full
        depth (the CLI for the bf16 kernels, the fp32 engine for the fp32
        ones); ``launches_by_path`` has every path's."""
        fp32 = main["dtype"] == "torch.float32"
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": count(paths[path], kernel, fp32),
                "launches_by_path": {p: count(c, kernel, fp32) for p, c in paths.items()},
                "max_abs_err": max(r["max_abs_err"] for r in recs),
                "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
                "bound_by": main["bound_by"], "library_ms": main["library_ms"],
                "dtype": main["dtype"], "shape": main["shape"]}

    flash_src, geglu_src = ("panacea_tpu_torch/csrc/flash_attention.cu",
                            "panacea_tpu_torch/csrc/geglu.cu")
    flash_tpu, geglu_tpu = "panacea_tpu/ops/flash_attention.py:33", "panacea_tpu/ops/geglu.py:64"
    log({"kernels": [
        summary("flash_attention", "flash_attention", flash_src, flash_tpu, flash, flash[0], "cli"),
        summary("geglu", "geglu", geglu_src, geglu_tpu, geglu, geglu[0], "cli"),
        summary("flash_attention_fp32", "flash_attention", flash_src, flash_tpu, flash32,
                flash32[0], "fp32_engine"),
        summary("geglu_fp32", "geglu", geglu_src, geglu_tpu, geglu32, geglu32[0],
                "fp32_engine")]})
    log(card)
    log({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:] not in ([], ["--kernels"]):
        sys.exit(f"usage: {sys.argv[0]} [--kernels]")
    sys.exit(main(kernels_only=sys.argv[1:] == ["--kernels"]))
