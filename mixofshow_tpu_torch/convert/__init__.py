from mixofshow_tpu_torch.convert.jax_params import (load_jax_params,
                                                    lora_from_jax,
                                                    state_dict_from_jax)

__all__ = ['load_jax_params', 'lora_from_jax', 'state_dict_from_jax']
