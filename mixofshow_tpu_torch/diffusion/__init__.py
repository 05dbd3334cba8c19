from mixofshow_tpu_torch.diffusion.ddpm import (DDPMSchedule, make_betas,
                                               make_ddpm_schedule)
from mixofshow_tpu_torch.diffusion.dpm_solver import (DPMSolverMultistep,
                                                      StepCoeffs)

__all__ = ['DDPMSchedule', 'DPMSolverMultistep', 'StepCoeffs', 'make_betas',
           'make_ddpm_schedule']
