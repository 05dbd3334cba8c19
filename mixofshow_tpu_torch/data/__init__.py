"""Training data, host-side (port of mixofshow_tpu/data, jax-free)."""
from mixofshow_tpu_torch.data.loader import (DataLoader, TrainBatcher,
                                             default_collate)
from mixofshow_tpu_torch.data.lora_dataset import LoraDataset
from mixofshow_tpu_torch.data.pil_transform import (PairCompose,
                                                    build_transform)
from mixofshow_tpu_torch.data.prompt_dataset import PromptDataset

__all__ = ['DataLoader', 'LoraDataset', 'PairCompose', 'PromptDataset',
           'TrainBatcher', 'build_transform', 'default_collate']
