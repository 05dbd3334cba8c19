from mixofshow_tpu_torch.convert.delta_io import (export_edlora_delta,
                                                  save_edlora_delta)
from mixofshow_tpu_torch.convert.jax_params import (load_jax_params,
                                                    lora_from_jax,
                                                    state_dict_from_jax)

__all__ = ['export_edlora_delta', 'load_jax_params', 'lora_from_jax',
           'save_edlora_delta', 'state_dict_from_jax']
