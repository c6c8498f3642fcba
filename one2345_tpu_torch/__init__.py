"""one2345_tpu_torch — the PyTorch + CUDA port of one2345_tpu for NVIDIA Hopper.

The JAX package ``one2345_tpu`` is the reference; this package mirrors its
module paths so that every module has a counterpart at the same sub-path.
It imports torch, numpy and einops only, never JAX or ``one2345_tpu``.

Ported so far: the image -> mesh path (``pipeline.runner.One2345Pipeline
.run``): preprocessing (thumbnail, the safety gate, SAM ViT-H segmentation,
recentring), Zero123-XL stage-1 / stage-2 sampling, with the UNet's
self-attention on hand-written CUDA flash-attention kernels (``csrc/``),
the LoFTR elevation estimate and the reconstruction stage (32 views ->
colored mesh, lod0 or coarse-to-fine lod1); the CLI, service and HTTP
server around it; the Zero123 finetune step and its CLI
(``training.train_zero123``, with the Objaverse readers); the
reconstruction trainer (the volume renderer,
``training.recon_trainer.ReconTrainer``, the ``training.train_recon``
CLI); the per-shape finetune (``recon.finetune``); and the evaluation
package (``eval``: Chamfer, F-score, the 24-view renders, CLIP similarity,
the sweep CLI).

Subpackages
-----------
core         config dataclasses, device, timing, checkpoints, metrics logs
diffusion    Zero123-XL latent diffusion (UNet, VAE, CLIP, DDIM)
elevation    LoFTR matching and the elevation pose sweep
eval         mesh metrics, the eval renders, CLIP similarity, the sweep CLI
geometry     camera rig, rays, projection, bilinear / trilinear sampling
native       host C++ (marching tetrahedra, PNG row unfiltering), built with
             g++ at first use
nn           building blocks of the reconstruction networks
ops          hand-written CUDA kernels and their plain PyTorch versions
pipeline     One2345Pipeline (the image -> mesh runner), the CLI, the
             service and the HTTP server
recon        reconstruction: FPN, cost volume, SDF MLP, blending net, mesh,
             the volume renderer, sphere tracing, validation renders, the
             per-shape finetune
segmentation SAM ViT-H and the safety checker
training     the Zero123 finetune step and its CLI, the reconstruction
             trainer and its CLI, view and scene readers, losses
utils        weight conversion from the JAX parameter trees, the PNG codec,
             PIL's and OpenCV's resizes, image preprocessing
"""

__version__ = "0.1.0"
