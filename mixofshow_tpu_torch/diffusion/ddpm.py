"""Training-side DDPM noise schedule (port of mixofshow_tpu/diffusion/ddpm.py).

The training loop needs only the forward diffusion (`add_noise`) and the
v-prediction target (`get_velocity`): gathers from fp32 alphas-cumprod
tables. The tables are computed in fp32 on the CPU and live on the device of
the schedule (`DDPMSchedule.to`), so a train step never copies them.
"""
from __future__ import annotations

import dataclasses

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


@dataclasses.dataclass(frozen=True)
class DDPMSchedule:
    """Frozen forward-diffusion schedule; the tables are fp32
    (num_train_timesteps,) tensors indexed by integer timestep."""

    num_train_timesteps: int
    prediction_type: str
    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor

    def to(self, device) -> 'DDPMSchedule':
        """The same schedule with its tables on `device`."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})

    def _coeffs(self, timesteps, ndim):
        shape = (-1,) + (1,) * (ndim - 1)
        return (self.sqrt_alphas_cumprod[timesteps].reshape(shape),
                self.sqrt_one_minus_alphas_cumprod[timesteps].reshape(shape))

    def add_noise(self, samples, noise, timesteps):
        """x_t = √acp_t · x_0 + √(1 − acp_t) · ε in fp32, returned in the
        samples' dtype; timesteps (B,) int, broadcast over the other
        dims."""
        a, s = self._coeffs(timesteps, samples.dim())
        return (a * samples.float() + s * noise.float()).to(samples.dtype)

    def get_velocity(self, samples, noise, timesteps):
        """v_t = √acp_t · ε − √(1 − acp_t) · x_0."""
        a, s = self._coeffs(timesteps, samples.dim())
        return (a * noise.float() - s * samples.float()).to(samples.dtype)

    def target(self, samples, noise, timesteps):
        """The loss target of `prediction_type`."""
        if self.prediction_type == 'epsilon':
            return noise
        if self.prediction_type == 'v_prediction':
            return self.get_velocity(samples, noise, timesteps)
        raise ValueError(f'Unknown prediction type {self.prediction_type}')


def make_ddpm_schedule(num_train_timesteps: int = 1000,
                       beta_start: float = 0.00085,
                       beta_end: float = 0.012,
                       beta_schedule: str = 'scaled_linear',
                       prediction_type: str = 'epsilon') -> DDPMSchedule:
    """The SD1.x training schedule (defaults match the SD1.5 config), with
    its tables on the CPU."""
    betas = make_betas(num_train_timesteps, beta_start, beta_end,
                       beta_schedule)
    acp = torch.cumprod(1.0 - betas, dim=0)
    return DDPMSchedule(num_train_timesteps, prediction_type, betas, acp,
                        torch.sqrt(acp), torch.sqrt(1.0 - acp))
