"""Beta schedules (port of `make_betas` in mixofshow_tpu/diffusion/ddpm.py;
the training-side DDPM schedule arrives with training)."""
from __future__ import annotations

import torch


def make_betas(num_train_timesteps: int, beta_start: float, beta_end: float,
               beta_schedule: str) -> torch.Tensor:
    """fp32 betas on the CPU ('linear' or SD1.x's 'scaled_linear')."""
    if beta_schedule == 'linear':
        return torch.linspace(beta_start, beta_end, num_train_timesteps,
                              dtype=torch.float32)
    if beta_schedule == 'scaled_linear':
        return torch.linspace(beta_start ** 0.5, beta_end ** 0.5,
                              num_train_timesteps, dtype=torch.float32) ** 2
    raise ValueError(f'Unknown beta schedule {beta_schedule}')
