"""Diffusion samplers (counterpart of ``panacea_tpu/diffusion/samplers.py``,
reference sampling.py:24-365 and sampling_utils.py).

The JAX package runs the steps as one ``lax.scan``; here they are a Python
loop. The sigma schedule stays a float32 numpy array (samplers.py:87-94), so
branches that depend on it alone are taken on the host. A ``denoiser`` is a
callable ``denoiser(x, sigma, cond) -> denoised`` already closed over the
network (built by the engine).

Randomness: the samplers that draw noise (Euler with churn, the ancestral
ones) draw it from ``generator`` (by default one seeded 0, as the JAX
samplers default to ``PRNGKey(0)``), or take it injected as ``noise``,
indexed by step: ``noise[i]`` has the latent's shape. The JAX samplers draw
step i from the i-th key of ``jax.random.split(rng, n_steps)``; injecting
those draws reproduces them. Without churn, Euler draws nothing.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from panacea_tpu_torch.diffusion.util import append_dims
from panacea_tpu_torch.registry import instantiate_from_config

DEFAULT_GUIDER = {"target": "panacea_tpu_torch.diffusion.guiders.IdentityGuider"}


def to_d(x, sigma, denoised):
    """Denoised prediction -> ODE derivative (sampling_utils.py:41-42)."""
    return (x - denoised) / append_dims(sigma, x.ndim)


def to_neg_log_sigma(sigma):
    return -torch.log(sigma)


def to_sigma(neg_log_sigma):
    return torch.exp(-neg_log_sigma)


def get_ancestral_step(sigma_from, sigma_to, eta: float = 1.0):
    """(sigma_down, sigma_up) of an ancestral step (sampling_utils.py:27-38)."""
    if not eta:
        return sigma_to, torch.zeros_like(sigma_to)
    sigma_up = torch.minimum(
        sigma_to,
        eta * (sigma_to**2 * (sigma_from**2 - sigma_to**2) / sigma_from**2) ** 0.5)
    sigma_down = (sigma_to**2 - sigma_up**2) ** 0.5
    return sigma_down, sigma_up


def linear_multistep_coeff(order: int, t: np.ndarray, i: int, j: int) -> float:
    """Adams-Bashforth coefficient over the sigma grid (sampling_utils.py:14-24)."""
    from scipy import integrate

    if order - 1 > i:
        raise ValueError(f"order {order} too high for step {i}")

    def fn(tau):
        prod = 1.0
        for k in range(order):
            if j == k:
                continue
            prod *= (tau - t[i - k]) / (t[i - j] - t[i - k])
        return prod

    return integrate.quad(fn, t[i], t[i + 1], epsrel=1e-4)[0]


def _vanishes(sigma_np, batch: int) -> bool:
    """The JAX samplers' ``sum(sigma) < 1e-14`` over a batch of equal sigmas."""
    return batch * float(sigma_np) < 1e-14


class _Noise:
    """Per-step gaussian noise of the latent's shape: ``noise[i]`` when
    injected, else a draw from ``generator``. With ``slab`` (one clip
    sampled over several ranks), ``x`` is the whole clip's latent and
    ``_Noise(...)[i]`` this rank's ``slab`` of step i's noise, as one
    process draws it; the engine gives such a ``_Noise`` to the sampler as
    its injected noise."""

    def __init__(self, noise, generator: Optional[torch.Generator], x: torch.Tensor,
                 slab: Optional[Callable[[torch.Tensor], torch.Tensor]] = None):
        self.noise, self.slab, self.whole = noise, slab, x
        if noise is None and generator is None:
            generator = torch.Generator(device=x.device).manual_seed(0)
        self.generator = generator

    def __call__(self, i: int, x: torch.Tensor) -> torch.Tensor:
        if self.noise is not None:
            return torch.as_tensor(self.noise[i], dtype=x.dtype, device=x.device)
        return torch.randn(x.shape, generator=self.generator, device=x.device, dtype=x.dtype)

    def __getitem__(self, i: int) -> torch.Tensor:
        return self.slab(self(i, self.whole))


class BaseDiffusionSampler:
    def __init__(self, discretization_config, guider_config=None,
                 num_steps: Optional[int] = None):
        self.num_steps = num_steps
        self.discretization = instantiate_from_config(discretization_config)
        self.guider = instantiate_from_config(guider_config or DEFAULT_GUIDER)

    def get_sigmas_np(self, num_steps: Optional[int] = None) -> np.ndarray:
        """Descending float32 schedule with an appended zero."""
        n = num_steps if num_steps is not None else self.num_steps
        if n is None:
            raise ValueError("num_steps must be set on the sampler or the call")
        sigmas = np.asarray(self.discretization.get_sigmas(n), dtype=np.float32)
        return np.append(sigmas, np.float32(0.0))

    def prepare_sampling_loop(self, x: torch.Tensor, cond, uc, num_steps):
        """(x scaled to the first sigma, s_in, host schedule, its tensor, uc)."""
        sigmas_np = self.get_sigmas_np(num_steps)
        # EDM init scaling: x ~ N(0, I) -> x * sqrt(1 + sigma_0^2) (sampling.py:50)
        x = x * np.sqrt(1.0 + sigmas_np[0] ** 2, dtype=np.float32)
        sigmas = torch.as_tensor(sigmas_np, device=x.device)
        return x, x.new_ones((x.shape[0],)), sigmas_np, sigmas, cond if uc is None else uc

    def denoise(self, x, denoiser, sigma, cond, uc):
        denoised = denoiser(*self.guider.prepare_inputs(x, sigma, cond, uc))
        return self.guider(denoised, sigma)


class EDMSampler(BaseDiffusionSampler):
    """Euler/Heun family with optional churn (sampling.py:85-133)."""

    def __init__(self, discretization_config, guider_config=None,
                 num_steps: Optional[int] = None, s_churn: float = 0.0, s_tmin: float = 0.0,
                 s_tmax: float = float("inf"), s_noise: float = 1.0):
        super().__init__(discretization_config, guider_config, num_steps)
        self.s_churn = s_churn
        self.s_tmin = s_tmin
        self.s_tmax = s_tmax
        self.s_noise = s_noise

    def _gammas(self, sigmas_np: np.ndarray) -> np.ndarray:
        n = len(sigmas_np)
        gammas = np.zeros(n - 1, dtype=np.float32)
        if self.s_churn > 0:
            g = min(self.s_churn / (n - 1), 2**0.5 - 1)
            mask = (sigmas_np[:-1] >= self.s_tmin) & (sigmas_np[:-1] <= self.s_tmax)
            gammas[mask] = g
        return gammas

    def _correction(self, euler_step, x, d, dt, next_sigma, next_sigma_np, denoiser,
                    cond, uc):
        raise NotImplementedError

    def __call__(self, denoiser, x: torch.Tensor, cond, uc=None,
                 num_steps: Optional[int] = None, generator: Optional[torch.Generator] = None,
                 noise=None, return_trajectory: bool = False):
        """``return_trajectory`` also returns the latent after every step,
        stacked (n_steps, *x.shape), as the JAX sampler does."""
        x, s_in, sigmas_np, sigmas, uc = self.prepare_sampling_loop(x, cond, uc, num_steps)
        gammas = self._gammas(sigmas_np)
        draw = _Noise(noise, generator, x) if self.s_churn > 0 else None
        traj = []
        for i in range(len(sigmas_np) - 1):
            sigma = s_in * sigmas[i]
            if gammas[i] > 0:
                sigma_hat = sigma * float(gammas[i] + np.float32(1.0))
                eps = draw(i, x) * self.s_noise
                x = x + eps * append_dims((sigma_hat**2 - sigma**2).clamp_min(0.0).sqrt(),
                                          x.ndim)
            else:
                sigma_hat = sigma
            d = to_d(x, sigma_hat, self.denoise(x, denoiser, sigma_hat, cond, uc))
            dt = append_dims(s_in * sigmas[i + 1] - sigma_hat, x.ndim)
            x = self._correction(x + dt * d, x, d, dt, s_in * sigmas[i + 1], sigmas_np[i + 1],
                                 denoiser, cond, uc)
            if return_trajectory:
                traj.append(x)
        return (x, torch.stack(traj)) if return_trajectory else x


class EulerEDMSampler(EDMSampler):
    """Single-eval Euler steps (sampling.py:214-218): the production sampler,
    25 steps with CFG 5.0, without churn."""

    def _correction(self, euler_step, *args):
        return euler_step


class HeunEDMSampler(EDMSampler):
    """Second-order Heun correction, skipped on the final (sigma -> 0) step
    (sampling.py:221-241)."""

    def _correction(self, euler_step, x, d, dt, next_sigma, next_sigma_np, denoiser,
                    cond, uc):
        if _vanishes(next_sigma_np, x.shape[0]) or not next_sigma_np > 0:
            return euler_step
        denoised = self.denoise(euler_step, denoiser, next_sigma, cond, uc)
        d_new = to_d(euler_step, next_sigma, denoised)
        return x + (d + d_new) / 2.0 * dt


class AncestralSampler(BaseDiffusionSampler):
    def __init__(self, discretization_config, guider_config=None,
                 num_steps: Optional[int] = None, eta: float = 1.0, s_noise: float = 1.0):
        super().__init__(discretization_config, guider_config, num_steps)
        self.eta = eta
        self.s_noise = s_noise

    def ancestral_euler_step(self, x, denoised, sigma, sigma_down):
        d = to_d(x, sigma, denoised)
        return x + append_dims(sigma_down - sigma, x.ndim) * d

    def ancestral_step(self, x, sigma_up, noise):
        """The noise of an ancestral step (taken where the next sigma is above 0)."""
        return x + noise * self.s_noise * append_dims(sigma_up, x.ndim)

    def sampler_step(self, sigma, next_sigma, denoiser, x, cond, uc):
        """One step before the ancestral noise: (x, sigma_up)."""
        raise NotImplementedError

    def __call__(self, denoiser, x: torch.Tensor, cond, uc=None,
                 num_steps: Optional[int] = None, generator: Optional[torch.Generator] = None,
                 noise=None):
        x, s_in, sigmas_np, sigmas, uc = self.prepare_sampling_loop(x, cond, uc, num_steps)
        draw = _Noise(noise, generator, x)
        for i in range(len(sigmas_np) - 1):
            x, sigma_up = self.sampler_step(s_in * sigmas[i], s_in * sigmas[i + 1], denoiser,
                                            x, cond, uc)
            if sigmas_np[i + 1] > 0:
                x = self.ancestral_step(x, sigma_up, draw(i, x))
        return x


class EulerAncestralSampler(AncestralSampler):
    """(sampling.py:244-251)"""

    def sampler_step(self, sigma, next_sigma, denoiser, x, cond, uc):
        sigma_down, sigma_up = get_ancestral_step(sigma, next_sigma, eta=self.eta)
        denoised = self.denoise(x, denoiser, sigma, cond, uc)
        return self.ancestral_euler_step(x, denoised, sigma, sigma_down), sigma_up


class DPMPP2SAncestralSampler(AncestralSampler):
    """DPM-Solver++(2S) ancestral (sampling.py:254-287)."""

    @staticmethod
    def _get_variables(sigma, sigma_down):
        t, t_next = to_neg_log_sigma(sigma), to_neg_log_sigma(sigma_down)
        h = t_next - t
        s = t + 0.5 * h
        return h, s, t, t_next

    @staticmethod
    def _get_mult(h, s, t, t_next):
        mult1 = to_sigma(s) / to_sigma(t)
        mult2 = torch.expm1(-0.5 * h)
        mult3 = to_sigma(t_next) / to_sigma(t)
        mult4 = torch.expm1(-h)
        return mult1, mult2, mult3, mult4

    def sampler_step(self, sigma, next_sigma, denoiser, x, cond, uc):
        sigma_down, sigma_up = get_ancestral_step(sigma, next_sigma, eta=self.eta)
        denoised = self.denoise(x, denoiser, sigma, cond, uc)
        x_euler = self.ancestral_euler_step(x, denoised, sigma, sigma_down)
        if float(sigma_down.sum()) < 1e-14:
            return x_euler, sigma_up
        # sigma_down of 0 in some rows: their result is x_euler (the where below)
        h, s, t, t_next = self._get_variables(sigma, sigma_down.clamp_min(1e-20))
        m = [append_dims(mm, x.ndim) for mm in self._get_mult(h, s, t, t_next)]
        denoised2 = self.denoise(m[0] * x - m[1] * denoised, denoiser, to_sigma(s), cond, uc)
        x_dpmpp2s = m[2] * x - m[3] * denoised2
        return torch.where(append_dims(sigma_down, x.ndim) > 0.0, x_dpmpp2s, x_euler), sigma_up


class DPMPP2MSampler(BaseDiffusionSampler):
    """DPM-Solver++(2M) multistep (sampling.py:290-365)."""

    def __call__(self, denoiser, x: torch.Tensor, cond, uc=None,
                 num_steps: Optional[int] = None, generator: Optional[torch.Generator] = None,
                 noise=None):
        x, s_in, sigmas_np, sigmas, uc = self.prepare_sampling_loop(x, cond, uc, num_steps)
        old_denoised = None
        for i in range(len(sigmas_np) - 1):
            sigma_b, next_b = s_in * sigmas[i], s_in * sigmas[i + 1]
            denoised = self.denoise(x, denoiser, sigma_b, cond, uc)
            t = to_neg_log_sigma(sigma_b)
            # next_sigma 0 on the final step: t_next finite, mult1 about 0 and
            # mult2 -1, so x_standard is `denoised`, as in the reference
            t_next = to_neg_log_sigma(next_b.clamp_min(1e-30))
            h = t_next - t
            mult1 = append_dims(to_sigma(t_next) / to_sigma(t), x.ndim)
            mult2 = append_dims(torch.expm1(-h), x.ndim)
            if old_denoised is None or _vanishes(sigmas_np[i + 1], x.shape[0]):
                x_new = mult1 * x - mult2 * denoised
            else:
                h_last = t - to_neg_log_sigma(s_in * sigmas[i - 1])
                r = (h_last / h.clamp_min(1e-30)).clamp_min(1e-30)
                mult3 = append_dims(1 + 1 / (2 * r), x.ndim)
                mult4 = append_dims(1 / (2 * r), x.ndim)
                x_new = mult1 * x - mult2 * (mult3 * denoised - mult4 * old_denoised)
            x, old_denoised = x_new, denoised
        return x


class LinearMultistepSampler(BaseDiffusionSampler):
    """Adams-Bashforth LMS (sampling.py:179-211). The coefficients are
    integrated with SciPy over the float32 schedule, as float32."""

    def __init__(self, discretization_config, guider_config=None,
                 num_steps: Optional[int] = None, order: int = 4):
        super().__init__(discretization_config, guider_config, num_steps)
        self.order = order

    def coefficients(self, sigmas_np: np.ndarray) -> np.ndarray:
        """(steps, order) float32; newest derivative first, unused slots 0."""
        t = sigmas_np.astype(np.float64)
        table = np.zeros((len(t) - 1, self.order), dtype=np.float32)
        for i in range(len(t) - 1):
            cur_order = min(i + 1, self.order)
            for j in range(cur_order):
                table[i, j] = linear_multistep_coeff(cur_order, t, i, j)
        return table

    def __call__(self, denoiser, x: torch.Tensor, cond, uc=None,
                 num_steps: Optional[int] = None, generator: Optional[torch.Generator] = None,
                 noise=None):
        x, s_in, sigmas_np, sigmas, uc = self.prepare_sampling_loop(x, cond, uc, num_steps)
        coeffs = self.coefficients(sigmas_np)
        ds = []   # newest first
        for i in range(len(sigmas_np) - 1):
            sigma = s_in * sigmas[i]
            ds = [to_d(x, sigma, self.denoise(x, denoiser, sigma, cond, uc))] + ds[:self.order - 1]
            x = x + sum(float(c) * d for c, d in zip(coeffs[i], ds))
        return x
