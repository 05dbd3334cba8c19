from mixofshow_tpu_torch.fusion.gradient_fusion import (
    compose_concepts, merge_kv_in_cross_attention, merge_new_concepts,
    merge_spatial_attention, merge_text_encoder, parse_new_concepts)

__all__ = ['compose_concepts', 'merge_kv_in_cross_attention',
           'merge_new_concepts', 'merge_spatial_attention',
           'merge_text_encoder', 'parse_new_concepts']
