"""DPM-Solver++(2M) multistep sampler: precomputed tables + a step function.

Port of mixofshow_tpu/diffusion/dpm_solver.py (diffusers
`DPMSolverMultistepScheduler` with solver_order=2, algorithm dpmsolver++,
linspace timestep spacing, lower-order-final below 15 steps). The per-step
scalars are computed once on the host in fp32 (`step_coeffs`); `step` is the
fp32 latent update.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mixofshow_tpu_torch.diffusion.ddpm import make_betas


@dataclasses.dataclass(frozen=True)
class StepCoeffs:
    """Per-step fp32 scalar tables, each (num_steps,), on the host."""
    timestep: np.ndarray    # int32 t fed to the UNet
    alpha_s0: np.ndarray    # sqrt(acp) at the current t
    sigma_s0: np.ndarray    # sqrt(1 - acp) at the current t
    alpha_t: np.ndarray     # at the step target (previous) timestep
    sigma_t: np.ndarray
    h: np.ndarray           # lambda_t - lambda_s0
    r0: np.ndarray          # h0 / h where h0 = lambda_s0 - lambda_s1
    use_order2: np.ndarray  # bool: apply the second-order correction


@dataclasses.dataclass(frozen=True)
class DPMSolverMultistep:
    num_train_timesteps: int
    prediction_type: str
    alpha_t: np.ndarray   # (T,) sqrt(alphas_cumprod), fp32
    sigma_t: np.ndarray   # (T,) sqrt(1 - alphas_cumprod)
    lambda_t: np.ndarray  # (T,) log(alpha / sigma)

    @staticmethod
    def create(num_train_timesteps: int = 1000,
               beta_start: float = 0.00085,
               beta_end: float = 0.012,
               beta_schedule: str = 'scaled_linear',
               prediction_type: str = 'epsilon') -> 'DPMSolverMultistep':
        betas = make_betas(num_train_timesteps, beta_start, beta_end,
                           beta_schedule)
        acp = torch.cumprod(1.0 - betas, dim=0)
        alpha = torch.sqrt(acp)
        sigma = torch.sqrt(1.0 - acp)
        lam = torch.log(alpha) - torch.log(sigma)
        return DPMSolverMultistep(num_train_timesteps, prediction_type,
                                  alpha.numpy(), sigma.numpy(), lam.numpy())

    def timesteps(self, num_inference_steps: int) -> np.ndarray:
        """Descending sample timesteps ('linspace' spacing)."""
        ts = np.linspace(0, self.num_train_timesteps - 1,
                         num_inference_steps + 1).round()[::-1][:-1]
        return ts.astype(np.int32)

    def step_coeffs(self, num_inference_steps: int,
                    lower_order_final: bool = True) -> StepCoeffs:
        ts = self.timesteps(num_inference_steps)
        n = len(ts)
        alpha, sigma, lam = self.alpha_t, self.sigma_t, self.lambda_t
        t_prev = np.concatenate([ts[1:], np.zeros((1,), np.int32)])
        t_s1 = np.concatenate([ts[:1], ts[:-1]])
        h = lam[t_prev] - lam[ts]
        h0 = lam[ts] - lam[t_s1]
        # r0 guarded against the dummy first step (h0 == 0 there)
        r0 = np.where(np.arange(n) == 0, 1.0,
                      h0 / np.where(h == 0, 1.0, h)).astype(np.float32)
        use_order2 = np.arange(n) >= 1
        if lower_order_final and n < 15:
            use_order2[-1] = False
        return StepCoeffs(ts, alpha[ts], sigma[ts], alpha[t_prev],
                          sigma[t_prev], h, r0, use_order2)

    def to_x0(self, model_output, sample, alpha_s0, sigma_s0):
        """The model output as a data (x0) prediction."""
        if self.prediction_type == 'epsilon':
            return (sample - sigma_s0 * model_output) / alpha_s0
        if self.prediction_type == 'v_prediction':
            return alpha_s0 * sample - sigma_s0 * model_output
        raise ValueError(f'Unknown prediction type {self.prediction_type}')

    def step(self, sample: torch.Tensor, m_prev: torch.Tensor,
             model_output: torch.Tensor, c: StepCoeffs, i: int):
        """One DPM-Solver++(2M) update at step i; returns (new_sample, m0),
        m0 being this step's x0 prediction, carried to the next step. The
        scalars are fp32 values, so the update is the reference's fp32
        arithmetic."""
        f32 = np.float32
        x = sample.float()
        m0 = self.to_x0(model_output.float(), x, float(c.alpha_s0[i]),
                        float(c.sigma_s0[i]))
        emh = f32(np.expm1(-c.h[i]))
        first = float(c.sigma_t[i] / c.sigma_s0[i]) * x \
            - float(c.alpha_t[i] * emh) * m0
        if c.use_order2[i]:
            d1 = (m0 - m_prev.float()) / float(c.r0[i])
            new = first - float(f32(0.5) * c.alpha_t[i] * emh) * d1
        else:
            new = first
        return new.to(sample.dtype), m0.to(sample.dtype)

    def init_noise_sigma(self) -> float:
        """DPM-Solver++ operates on unscaled latents."""
        return 1.0
