"""Hand-written Hopper kernels, each beside its plain PyTorch twin: the
forward-only kernels of the sampling paths (fused_attention.py, gn_stats.py's
statistics, region_attention.py), the differentiable flash attention of
training (flash_attention.py) and GroupNorm's apply (gn_stats.py). The
fusion solver (solve.py) is plain torch.linalg, as the JAX package left it
to XLA.

`KERNELS` maps each kernel's name to the wrapper that launches it; a
wrapper's `launches` attribute counts its kernel launches in this process.
"""
from mixofshow_tpu_torch.ops.fused_attention import (attention_block,
                                                     attention_packed,
                                                     attn_fwd)
from mixofshow_tpu_torch.ops import flash_attention as _flash
from mixofshow_tpu_torch.ops import region_attention as _region
from mixofshow_tpu_torch.ops.gn_stats import scale_bias_act, spatial_sums

# (`ops.region_attention` and `ops.flash_attention` stay the modules; their
# wrappers have the same names)
KERNELS = {'attn_fwd': attn_fwd, 'gn_spatial_sums': spatial_sums,
           'attn_block': attention_block,
           'region_attn': _region.region_attention,
           'flash_fwd': _flash.flash_fwd,
           'flash_bwd_dkv': _flash.flash_bwd_dkv,
           'flash_bwd_dq': _flash.flash_bwd_dq,
           'gn_apply': scale_bias_act}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


__all__ = ['KERNELS', 'attention_block', 'attention_packed', 'attn_fwd',
           'launch_counts', 'reset_launch_counts', 'scale_bias_act',
           'spatial_sums']
