from mixofshow_tpu_torch.pipelines.concepts import (
    NUM_CROSS_ATTENTION_LAYERS, bind_concept_prompt, init_concepts)
from mixofshow_tpu_torch.pipelines.pipeline_edlora import (EDLoRAPipeline,
                                                           PendingSample)
from mixofshow_tpu_torch.pipelines.pipeline_regional import \
    RegionallyT2IAdapterPipeline

__all__ = ['EDLoRAPipeline', 'NUM_CROSS_ATTENTION_LAYERS', 'PendingSample',
           'RegionallyT2IAdapterPipeline', 'bind_concept_prompt',
           'init_concepts']
