"""Hand-written Hopper kernels of the sampling paths, each beside its plain
PyTorch twin (see fused_attention.py, gn_stats.py and region_attention.py).

`KERNELS` maps each kernel's name to the wrapper that launches it; a
wrapper's `launches` attribute counts its kernel launches in this process.
"""
from mixofshow_tpu_torch.ops.fused_attention import (attention_block,
                                                     attention_packed,
                                                     attn_fwd)
from mixofshow_tpu_torch.ops import region_attention as _region
from mixofshow_tpu_torch.ops.gn_stats import spatial_sums

# (`ops.region_attention` stays the module; its wrapper has the same name)
KERNELS = {'attn_fwd': attn_fwd, 'gn_spatial_sums': spatial_sums,
           'attn_block': attention_block,
           'region_attn': _region.region_attention}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


__all__ = ['KERNELS', 'attention_block', 'attention_packed', 'attn_fwd',
           'launch_counts', 'reset_launch_counts', 'spatial_sums']
