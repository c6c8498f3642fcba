"""Seconds per mesh in the diffusion stage's spans (``stage1`` twice,
``stage2_view0``, ``stage2``): the conditioning, the sampler loops over the
UNet and the VAE decodes (``diffusion/zero123.py``, ``ddim.py`` /
``dpm_solver.py``, ``unet.py``, ``vae.py``, ``clip.py``)."""

from portbench.harness import span_mean


def read(readings):
    return span_mean(readings, ("stage1", "stage2_view0", "stage2"))
