from mixofshow_tpu_torch.convert.convert_edlora import convert_edlora
from mixofshow_tpu_torch.convert.delta_io import (convert_edlora_delta,
                                                  export_edlora_delta,
                                                  load_edlora_delta,
                                                  save_edlora_delta)
from mixofshow_tpu_torch.convert.diffusers_export import save_pipeline_params
from mixofshow_tpu_torch.convert.diffusers_import import load_pipeline_params
from mixofshow_tpu_torch.convert.jax_params import (load_jax_params,
                                                    lora_from_jax,
                                                    state_dict_from_jax)

__all__ = ['convert_edlora', 'convert_edlora_delta', 'export_edlora_delta', 'load_edlora_delta',
           'load_jax_params', 'load_pipeline_params', 'lora_from_jax',
           'save_edlora_delta', 'save_pipeline_params',
           'state_dict_from_jax']
