#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``panacea_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py             # every phase
    python3 chip_smoke.py --kernels   # phases 1 and 2 only

Phases, in order; any failure exits non-zero:
  1. build: compile the port's CUDA kernels from ``panacea_tpu_torch/csrc``
     with nvcc (one process per source, started together); an ignored
     ``setmaxnreg`` in the ptxas report is a failure;
  2. kernels: each kernel at every shape the generation path gives it and at
     ragged and tiny shapes, held against its plain PyTorch version on the
     same bf16 inputs (per element, the rule of
     ``panacea_tpu_torch/ops/tolerance.py``), and timed beside the plain
     version, a one-call PyTorch yardstick and its bound;
  3. small input: the tiny engine on the card (bf16, kernels) against the
     same weights on the CPU (fp32, plain versions), two sampler steps;
  4. main path: ``DiffusionEngine3D.log_images`` at full production width
     (INFERENCE_NUSCENES: 6 views x 8 frames, 256 x 3072 images, CFG batch
     of 16 frames), random weights from a seed; the kernels' launch counts
     must match 21 flash and 69 GEGLU launches per network evaluation.

The last three lines of standard output are the ``{"kernels": [...]}``
summary, the card's name and power limit as nvidia-smi reports them, and
``{"ok": true, "device": {...}}``. Without a CUDA device, or outside the
repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

SEED = 0
# random weights: the parameters the model zero-initialises get this std, so
# every branch computes while the output stays in a trained model's range
ZERO_INIT_STD = 0.02
MAIN_STEPS = 25        # the production sampler's step count
PEAK_BF16 = 989e12     # H100 SXM dense bf16 flop/s (NVIDIA data sheet)
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


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def check_flash(torch, F, fa, tol, dev, b, sq, skv, h, d, ragged=False, merged_kv=False,
                timed=True, lens=None):
    """``merged_kv``: k and v are the two halves of one (B, Skv, 2 H D)
    projection, the strided layout the cross-view call gives the kernel.
    ``ragged`` draws the rows' key counts; ``lens`` gives them."""
    g = torch.Generator(device=dev).manual_seed(sq * 7 + skv + d)
    q = torch.randn((b, sq, h, d), generator=g, device=dev).bfloat16()
    if merged_kv:
        kv = torch.randn((b, skv, 2 * h * d), generator=g, device=dev).bfloat16()
        k, v = (t.unflatten(-1, (h, d)) for t in kv.chunk(2, dim=-1))
    else:
        k = torch.randn((b, skv, h, d), generator=g, device=dev).bfloat16()
        v = torch.randn((b, skv, h, d), generator=g, device=dev).bfloat16()
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
    ratio = tol.worst_ratio(got, want, **tol.FLASH)
    rec = {"kernel": "flash_attention", "route": route,
           "shape": {"B": b, "Sq": sq, "Skv": skv, "H": h, "D": d, "ragged": ragged,
                     "kv": "merged" if merged_kv else "contiguous"},
           "max_abs_err": err, "rms_want": want.float().square().mean().sqrt().item(),
           "worst_ratio": ratio, "tol": tol.FLASH}
    if timed:
        mask = None
        if lens is not None:
            mask = (torch.arange(skv, device=dev)[None] < lens[:, None])[:, None, None, :]
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        kv_eff = float(lens.sum().item()) / b if lens is not None else skv  # keys the rows need
        flops = 4.0 * b * h * sq * kv_eff * d
        nbytes = 2.0 * (2 * b * sq * h * d + 2 * b * kv_eff * h * d) + (4 * b if ragged else 0)
        rec["bound_ms"], rec["bound_by"] = bound(flops, nbytes)
        rec["ms"] = time_ms(torch, lambda: fa.flash_attention(q, k, v, kv_lens=lens), 20)
        rec["plain_ms"] = time_ms(
            torch, lambda: fa.flash_attention_plain(q, k, v, kv_lens=lens), 2)
        rec["library_ms"] = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask), 20)
        rec["host_us"] = host_us(torch, lambda: fa.flash_attention(q, k, v, kv_lens=lens), 50)
    log(rec)
    if not ratio <= 1.0:
        raise AssertionError(f"flash_attention disagrees with its plain version: {rec}")
    return rec


def check_geglu(torch, F, gg, tol, dev, tokens, c, timed=True, inner=None):
    inner = 4 * c if inner is None else inner
    g = torch.Generator(device=dev).manual_seed(tokens + c)
    x = torch.randn((tokens, c), generator=g, device=dev).bfloat16()
    w = (torch.randn((2 * inner, c), generator=g, device=dev) * c**-0.5).bfloat16()
    b = (torch.randn(2 * inner, generator=g, device=dev) * 0.1).bfloat16()
    got = gg.geglu(x, w, b)
    want = gg.geglu_plain(x, w, b)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    ratio = tol.worst_ratio(got, want, **tol.GEGLU)
    rec = {"kernel": "geglu", "shape": {"tokens": tokens, "C": c, "inner": inner},
           "max_abs_err": err, "rms_want": want.float().square().mean().sqrt().item(),
           "worst_ratio": ratio, "tol": tol.GEGLU}
    if timed:
        flops = 4.0 * tokens * c * inner
        nbytes = 2.0 * (tokens * c + 2 * inner * c + 2 * inner + tokens * inner)
        rec["bound_ms"], rec["bound_by"] = bound(flops, nbytes)
        rec["ms"] = time_ms(torch, lambda: gg.geglu(x, w, b), 20)
        rec["plain_ms"] = time_ms(torch, lambda: gg.geglu_plain(x, w, b), 3)
        rec["library_ms"] = time_ms(torch, lambda: F.linear(x, w, b), 20)

        def unfused():  # the whole function in PyTorch calls, bf16
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


def main_path(torch, np, dev, fa, gg, steps: int, card: str):
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
    torch.cuda.reset_peak_memory_stats()
    fa.flash_attention.launches = 0
    fa.flash_attention.route_launches.update(wgmma=0, mma=0)
    gg.geglu.launches = 0
    t0 = time.perf_counter()
    logd = eng.log_images(batch, N=1, generator=torch.Generator(device=dev).manual_seed(SEED),
                          num_steps=steps)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = {"flash_attention": fa.flash_attention.launches, "geglu": gg.geglu.launches}

    shapes = {"inputs": (t, ih, iw, 3), "reconstructions": (t, ih, iw, 3),
              "samples": (t, ih, iw, 3), "control": (t, ih, iw, 19)}
    finite = {k: bool(torch.isfinite(logd[k]).all()) for k in shapes}
    ok_shape = {k: tuple(logd[k].shape) == s for k, s in shapes.items()}
    steady = sorted(step_s[1:] or step_s)[len(step_s[1:] or step_s) // 2]
    rec = {"phase": "main_path", "card": card, "params": n_params,
           "dtype": str(eng.dtype), "steps": steps, "setup_s": setup_s,
           "log_images_s": total_s, "step_s": step_s, "s_per_step": steady,
           "s_per_clip_25_steps": total_s - sum(step_s) + 25 * steady,
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
    return launches


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
    card = card_line()
    log({"phase": "env", "torch": torch.__version__, "cuda": torch.version.cuda,
         "python": sys.version.split()[0], "card": card,
         "device": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()})

    t0 = time.perf_counter()
    _build.build_all()
    log({"phase": "build", "seconds": time.perf_counter() - t0})
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

    if kernels_only:
        log({"phase": "kernels_only", "ok": True})
        return 0
    small_input_agreement(torch, np, dev)
    launches = main_path(torch, np, dev, fa, gg, MAIN_STEPS, card)

    def summary(name, source, replaces, recs, main):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches[name], "max_abs_err": max(r["max_abs_err"] for r in recs),
                "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
                "bound_by": main["bound_by"], "library_ms": main["library_ms"],
                "shape": main["shape"]}

    log({"kernels": [
        summary("flash_attention", "panacea_tpu_torch/csrc/flash_attention.cu",
                "panacea_tpu/ops/flash_attention.py:33", flash, flash[0]),
        summary("geglu", "panacea_tpu_torch/csrc/geglu.cu", "panacea_tpu/ops/geglu.py:64",
                geglu, geglu[0])]})
    log(card)
    log({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:] not in ([], ["--kernels"]):
        sys.exit(f"usage: {sys.argv[0]} [--kernels]")
    sys.exit(main(kernels_only=sys.argv[1:] == ["--kernels"]))
