"""one2345_tpu_torch — the PyTorch + CUDA port of one2345_tpu for NVIDIA Hopper.

The JAX package ``one2345_tpu`` is the reference; this package mirrors its
module paths so that every module has a counterpart at the same sub-path.
It imports torch, numpy and einops only, never JAX or ``one2345_tpu``.

Ported so far: the multi-view generation half of the image -> mesh path
(Zero123-XL stage-1 / stage-2 sampling), with the UNet's self-attention on
a hand-written CUDA flash-attention kernel (``csrc/flash_attention_fwd.cu``).

Subpackages
-----------
core         config dataclasses, timing
diffusion    Zero123-XL latent diffusion (UNet, VAE, CLIP, DDIM)
ops          hand-written CUDA kernels and their plain PyTorch versions
utils        weight conversion from the JAX parameter trees
"""

__version__ = "0.1.0"
