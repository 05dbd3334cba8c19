"""Hand-written Hopper kernels of the sampling path, each beside its plain
PyTorch twin (see fused_attention.py and gn_stats.py).

`KERNELS` maps each kernel's name to the wrapper that launches it; a
wrapper's `launches` attribute counts its kernel launches in this process.
"""
from mixofshow_tpu_torch.ops.fused_attention import (attention_block,
                                                     attention_packed,
                                                     attn_fwd)
from mixofshow_tpu_torch.ops.gn_stats import spatial_sums

KERNELS = {'attn_fwd': attn_fwd, 'gn_spatial_sums': spatial_sums,
           'attn_block': attention_block}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


__all__ = ['KERNELS', 'attention_block', 'attention_packed', 'attn_fwd',
           'launch_counts', 'reset_launch_counts', 'spatial_sums']
