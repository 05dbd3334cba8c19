from mixofshow_tpu_torch.utils.device import (COMPUTE_DTYPE, as_device,
                                             exact_fp32, require_cuda)

__all__ = ['COMPUTE_DTYPE', 'as_device', 'exact_fp32', 'require_cuda']
