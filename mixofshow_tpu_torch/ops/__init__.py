"""Hand-written Hopper kernels, each beside its plain PyTorch twin: the
forward-only kernels of the sampling paths (fused_attention.py, gn_stats.py,
region_attention.py) and the differentiable flash attention of training
(flash_attention.py).

`KERNELS` maps each kernel's name to the wrapper that launches it; a
wrapper's `launches` attribute counts its kernel launches in this process.
"""
from mixofshow_tpu_torch.ops.fused_attention import (attention_block,
                                                     attention_packed,
                                                     attn_fwd)
from mixofshow_tpu_torch.ops import flash_attention as _flash
from mixofshow_tpu_torch.ops import region_attention as _region
from mixofshow_tpu_torch.ops.gn_stats import spatial_sums

# (`ops.region_attention` and `ops.flash_attention` stay the modules; their
# wrappers have the same names)
KERNELS = {'attn_fwd': attn_fwd, 'gn_spatial_sums': spatial_sums,
           'attn_block': attention_block,
           'region_attn': _region.region_attention,
           'flash_fwd': _flash.flash_fwd,
           'flash_bwd_dkv': _flash.flash_bwd_dkv,
           'flash_bwd_dq': _flash.flash_bwd_dq}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


__all__ = ['KERNELS', 'attention_block', 'attention_packed', 'attn_fwd',
           'launch_counts', 'reset_launch_counts',
           'spatial_sums']
