"""DeepCountAutoencoder (Eraslan et al. 2019), port of
``sisua_tpu/models/dca.py``: a count autoencoder whose latent is coerced to
the deterministic 'linear' head (or kept 'relu'/'mse'), so it takes no
noise and adds no KL; the objective is the count reconstruction
log-likelihood (NB/ZINB) or plain MSE."""

from __future__ import annotations

from ..rv import RVmeta, parse_rv
from .base import SingleCellModel, _flatten

__all__ = ["DeepCountAutoencoder"]


class DeepCountAutoencoder(SingleCellModel):

  def __init__(self, outputs, latents=None, latent_dim: int = 10, **kwargs):
    if latents is None:
      latents = RVmeta(int(latent_dim), "linear", True, "latents")
    else:
      latents = tuple(
          z if z.is_deterministic else z.replace(posterior="linear")
          for z in (parse_rv(z, f"latent{i}")
                    for i, z in enumerate(_flatten(latents))))
    super().__init__(outputs, latents=latents, **kwargs)
