from mixofshow_tpu_torch.text.tokenizer import CLIPTokenizer

__all__ = ['CLIPTokenizer']
