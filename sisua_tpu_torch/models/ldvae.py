"""LDVAE — linearly decoded VAE (Svensson et al. 2020), port of
``sisua_tpu/models/ldvae.py``.

SCVI's encoders, library prior and count likelihood, with the decoder
stack forced to the identity (``NetConf(units=())``): the count head's
``MeanScale`` is one linear map from z to the genes, whose columns are
per-gene loadings of each latent dimension (``get_loadings``).
Dispersion defaults to the per-gene 'single'.
"""

from __future__ import annotations

import numpy as np

from ..nn import NetConf
from .scvi import SCVI

__all__ = ["LDVAE"]


class LDVAE(SCVI):
  """SCVI with a linear decoder and interpretable per-gene loadings."""

  def __init__(self, outputs, **kwargs):
    # the linear decoder defines the family: a given decoder (a checkpoint
    # rebuild passes the identity back) is replaced by the identity
    kwargs.pop("decoder", None)
    kwargs.setdefault("dispersion", "single")
    super().__init__(outputs,
                     decoder=NetConf(units=(), name="decoder_identity"),
                     **kwargs)

  def get_loadings(self) -> np.ndarray:
    """Per-gene loadings of each latent dimension, (genes, z): the
    ``MeanScale`` weight's z columns (a torch ``Linear`` weight is (out,
    in); the batch one-hot's columns under ``n_batch`` are left out). The
    JAX package wraps them in a pandas DataFrame indexed by the recorded
    gene names; the port imports no pandas, so the rows are in the order
    of ``metadata[<main output name>]``."""
    weight = self.module.MeanScale.weight.detach().cpu().numpy()
    return np.ascontiguousarray(weight[:, :int(self.latents[0].dim)],
                                np.float32)
