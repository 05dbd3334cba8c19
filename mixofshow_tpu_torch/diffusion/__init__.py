from mixofshow_tpu_torch.diffusion.ddpm import make_betas
from mixofshow_tpu_torch.diffusion.dpm_solver import (DPMSolverMultistep,
                                                      StepCoeffs)

__all__ = ['DPMSolverMultistep', 'StepCoeffs', 'make_betas']
