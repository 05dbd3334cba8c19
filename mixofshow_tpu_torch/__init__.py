"""mixofshow_tpu_torch: the PyTorch/CUDA port of mixofshow_tpu.

The JAX package `mixofshow_tpu` is the reference; this package mirrors its
layout (models/, ops/, diffusion/, text/, pipelines/, fusion/, data/,
convert/, parallel/, utils/) with one port module per reference module. It imports
torch and never jax, and never `mixofshow_tpu` (whose `__init__` loads
jax).

Conventions:
  * activations are NCHW, conv weights OIHW, Linear weights (out, in);
  * every entry point takes an explicit `device`; nothing defaults to the CPU;
  * noise comes from explicit `torch.Generator`s;
  * each hand-written kernel (ops/) has a plain PyTorch twin in the same
    module. A wrapper runs the plain version for a CPU tensor and launches
    its kernel for a CUDA tensor; it raises on a shape the kernel cannot take.
"""

__version__ = '0.1.0'
