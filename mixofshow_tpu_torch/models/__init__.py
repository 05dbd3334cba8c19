from mixofshow_tpu_torch.models.clip import CLIPTextConfig, CLIPTextModel
from mixofshow_tpu_torch.models.unet import UNet, UNetConfig
from mixofshow_tpu_torch.models.vae import AutoencoderKL, VAEConfig

__all__ = ['AutoencoderKL', 'CLIPTextConfig', 'CLIPTextModel', 'UNet',
           'UNetConfig', 'VAEConfig']
