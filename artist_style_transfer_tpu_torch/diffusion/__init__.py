"""Class-conditional Gaussian diffusion with classifier guidance (counterpart of the JAX
``diffusion`` package).

The reference names this capability ("In the works: class-conditional guided Gaussian
Diffusion model") but ships no source; the JAX package implements the standard one,
and this is its port: DDPM (epsilon prediction, linear or cosine betas) over
artist-labelled paintings, sampled by DDPM, DDIM or DPM-Solver++(2M), with guidance
from the ResNet-50 artist classifier of 'classifier' training mode, and scored by the
classifier Fréchet distance. ``python -m artist_style_transfer_tpu_torch.diffusion.cli``
trains, samples and evaluates from the command line.
"""

from artist_style_transfer_tpu_torch.diffusion.gaussian import GaussianDiffusion  # noqa: F401
from artist_style_transfer_tpu_torch.diffusion.unet import (  # noqa: F401
    diff_model_apply,
    init_diff_model,
)
from artist_style_transfer_tpu_torch.diffusion.sample import (  # noqa: F401
    diff_sample,
    diff_sample_ddim,
    diff_sample_dpmpp,
)
from artist_style_transfer_tpu_torch.diffusion.train import train_diffusion  # noqa: F401
from artist_style_transfer_tpu_torch.diffusion.evaluate import cfid, frechet_distance  # noqa: F401
