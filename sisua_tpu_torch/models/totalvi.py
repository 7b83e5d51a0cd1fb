"""TotalVI — joint RNA + protein variational inference (Gayoso et al. 2021),
port of ``sisua_tpu/models/totalvi.py``.

  * the encoder reads log1p of concat(rna, protein) (and the batch one-hot
    under ``n_batch``); latents (z, library l) with SCVI's library prior
    from the per-cell stats of the RNA matrix;
  * RNA: SCVI's log-space decode, log μ = l + log_softmax(scale) floored at
    log 1e-7 and log θ raw (``NegativeBinomialLog``, the kernels' 'loglog'
    route), zero-inflated for a 'zinbd'/'zinb' output;
  * proteins: a per-protein background NB(β) / foreground NB(β·α) mixture
    (``NegativeBinomialMixture``). The background is hierarchical: the
    decoder gives q(log β | z) = Normal(μ, σ), a reparameterized draw sets
    β, and KL(q(log β) ‖ p(log β)) against a learned per-protein Normal
    prior joins the ELBO, since q(log β) rides the forward's latent tuples
    as a nuisance latent that ``encode`` and serving leave out.
    ``foreground_probability`` of the protein head is the denoised signal.

The forward draws twice, as the JAX module calls ``make_rng('sample')``
twice: the latents, then log β (its noise is the forward's third
``noise`` entry). ``decode`` draws nothing: log β at its posterior mean.
``mask_protein=True`` trains semi-supervised: the protein likelihood is
masked like a SISUA label head, and the encoder's protein slice is zeroed
for unlabeled cells in training (the background KL stays unmasked, as in
the JAX package).
"""

from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import dist as D
from ..nn import NetConf, dense, parse_netconf
from ..rv import RVmeta, parse_rv
from .base import SingleCellModel, _as_device_matrix, _flatten
from .module import (_LOG_SCALE_FLOOR, VAEModule, VAEOutput,
                     with_library_prior)

__all__ = ["TotalVI", "TotalVIModule"]


class TotalVIModule(VAEModule):
  """Joint RNA+ADT module; its input is concat(rna, protein) counts (then
  the batch block). Submodules and parameters carry the flax names."""

  def __init__(self, outputs, latents, encoder_confs, decoder_confs,
               log_norm: bool = True, reduce_latent: str = "first",
               n_genes: int = 0, n_proteins: int = 0,
               clip_library: float = 1e3, n_batch: int = 0,
               generator: Optional[torch.Generator] = None):
    if (len(outputs) != 2 or int(n_genes) != outputs[0].dim
        or int(n_proteins) != outputs[1].dim):
      raise ValueError(f"TotalVIModule needs (rna, protein) outputs of "
                       f"widths n_genes={n_genes}, n_proteins={n_proteins}")
    super().__init__(outputs, latents, encoder_confs, decoder_confs,
                     log_norm=log_norm, reduce_latent="first",
                     n_batch=n_batch, generator=generator)
    self.n_genes, self.n_proteins = int(n_genes), int(n_proteins)
    self.clip_library = float(clip_library)
    hidden = self.decoders[0].out_dim
    self.RnaScale = dense(hidden, self.n_genes, generator)
    self.RnaDispersion = dense(hidden, self.n_genes, generator)
    if self.outputs[0].is_zero_inflated:
      self.RnaDropout = dense(hidden, self.n_genes, generator)
    self.ProteinBackMean = dense(hidden, self.n_proteins, generator)
    self.ProteinBackScale = dense(hidden, self.n_proteins, generator)
    self.ProteinForeScale = dense(hidden, self.n_proteins, generator)
    self.ProteinMixing = dense(hidden, self.n_proteins, generator)
    for name in ("protein_dispersion", "background_prior_mean",
                 "background_prior_log_scale"):
      self.register_parameter(name, nn.Parameter(torch.zeros(
          self.n_proteins)))

  def _main_dim(self) -> int:
    return self.outputs[0].dim + self.outputs[1].dim

  def latent_priors(self, library=None, like=None):
    return with_library_prior(super().latent_priors(library, like), library)

  def _decode_full(self, latent_samples, generator=None, batch=None,
                   draw: bool = False, noise=None):
    """(rna, protein) distributions and the background triple
    (q(log β), log β, p(log β)). ``draw``: log β is a reparameterized
    draw (``noise`` feeds it), else q's mean."""
    z, l = latent_samples
    l = torch.clamp(l, 0.0, self.clip_library)
    d = self.decoders[0](self._decoder_input(z, batch), generator)
    log_scale = torch.clamp_min(F.log_softmax(self.RnaScale(d), dim=-1),
                                _LOG_SCALE_FLOOR)
    rna = D.NegativeBinomialLog(log_loc=l + log_scale,
                                log_disp=self.RnaDispersion(d))
    if self.outputs[0].is_zero_inflated:
      rna = D.ZeroInflated(count_distribution=rna,
                           gate_logits=self.RnaDropout(d))
    qb_mean = torch.clamp(self.ProteinBackMean(d), -8.0, 12.0)
    qb_scale = F.softplus(self.ProteinBackScale(d)) + 1e-4
    q_back = D.Independent(D.Normal(loc=qb_mean, scale=qb_scale), 1)
    if draw:
      (log_back,) = self._sample((q_back,), (), generator, noise)
    else:
      log_back = qb_mean
    p_back = D.Independent(D.Normal(
        loc=self.background_prior_mean,
        scale=torch.exp(self.background_prior_log_scale)), 1)
    back = torch.exp(torch.clamp(log_back, -8.0, 12.0))
    fore = back * (F.softplus(self.ProteinForeScale(d)) + 1.0 + 1e-4)
    disp = torch.exp(self.protein_dispersion).expand(fore.shape)
    protein = D.NegativeBinomialMixture(
        loc_back=back, loc_fore=fore, disp=disp,
        mixing_logits=self.ProteinMixing(d))
    return ((D.Independent(rna, 1), D.Independent(protein, 1)),
            (q_back, log_back, p_back))

  def decode(self, latent_samples, library=None, generator=None, batch=None):
    return self._decode_full(latent_samples, generator, batch)[0]

  def forward(self, x, library=None, sample_shape=(), generator=None,
              noise=None) -> VAEOutput:
    _, b = self.split_batch(x)
    qZ = self.encode(x, generator)
    n = len(qZ)
    zs = self._sample(qZ, sample_shape, generator,
                      None if noise is None else noise[:n])
    outs, (q_back, log_back, p_back) = self._decode_full(
        zs, generator, b, draw=True,
        noise=None if noise is None else noise[n:])
    return VAEOutput(outputs=outs, latents=qZ + (q_back,),
                     latent_samples=zs + (log_back,),
                     priors=self.latent_priors(library, like=x) + (p_back,))


class TotalVI(SingleCellModel):
  """Joint RNA+protein model; outputs = (rna RVmeta, protein RVmeta). The
  data is ``[rna, protein]`` (then the batch one-hot under ``n_batch``)."""

  module_cls = TotalVIModule
  n_input_sources = 2  # the encoder reads concat(rna, protein)

  def __init__(self,
               outputs,
               latents=None,
               library=None,
               encoder=None,
               clip_library: float = 1e3,
               mask_protein: bool = False,
               **kwargs):
    outputs = [parse_rv(o, f"output{i}")
               for i, o in enumerate(_flatten(outputs))]
    if len(outputs) != 2:
      raise ValueError("TotalVI takes exactly (rna, protein) outputs")
    if outputs[0].posterior not in ("zinbd", "nbd", "zinb", "nb"):
      raise ValueError("rna posterior must be a count likelihood, got "
                       f"{outputs[0].posterior}")
    # the module builds the heads; the specs carry widths and inflation
    outputs[0] = outputs[0].replace(projection=False)
    outputs[1] = outputs[1].replace(projection=False, posterior="nbd")
    # a metamodel rebuild passes (z, library) and (encoder,) back in
    if isinstance(latents, (tuple, list)) and len(latents) == 2 \
        and library is None:
      latents, library = latents
    if latents is None:
      latents = RVmeta(16, "diag", True, "latents")
    if library is None:
      library = RVmeta(1, "normal", True, "library")
    if isinstance(encoder, (tuple, list)) and len(encoder) == 1:
      encoder = encoder[0]
    if encoder is None:
      encoder = NetConf((128, 128), batchnorm=True, dropout=0.1,
                        name="encoder")
    for k in ("reduce_latent", "n_genes", "n_proteins"):
      kwargs.pop(k, None)
    super().__init__(tuple(outputs),
                     latents=(parse_rv(latents, "latents"),
                              parse_rv(library, "library")),
                     encoder=parse_netconf(encoder, "encoder"),
                     reduce_latent="first",
                     n_genes=outputs[0].dim,
                     n_proteins=outputs[1].dim,
                     clip_library=float(clip_library),
                     **kwargs)
    self.mask_protein = bool(mask_protein)
    if mask_protein:
      self.mask_outputs = True
    self._init_kwargs_for_save["mask_protein"] = self.mask_protein

  @property
  def uses_library(self) -> bool:
    return True

  def fit(self, *args, labels_percent: float = 0.8, **kwargs):
    """``SingleCellModel.fit``; warns, as the JAX package does, when
    ``mask_protein`` trains below a 10% label budget without
    ``mask_renorm`` (the protein head is known to collapse there)."""
    if (self.mask_protein and not self.mask_renorm
        and 0.0 < labels_percent < 0.1):
      warnings.warn(
          f"TotalVI(mask_protein=True) at labels_percent={labels_percent} "
          "without mask_renorm: the protein head is known to collapse "
          "below a ~10% label budget. Construct the model with "
          "mask_renorm=True for low label budgets.", UserWarning,
          stacklevel=2)
    return super().fit(*args, labels_percent=labels_percent, **kwargs)

  def _masked_module_input(self, batch, training: bool) -> torch.Tensor:
    inputs = batch["inputs"]
    mask = batch.get("mask")
    if training and self.mask_protein and mask is not None:
      m = mask.to(torch.float32).reshape(-1, 1)
      inputs = [inputs[0], inputs[1] * m, *inputs[2:]]
    return self._module_input(inputs)

  def denoised_proteins(self, inputs, batch_size: int = 256) -> np.ndarray:
    """Posterior foreground probability per protein, (n, proteins):
    TotalVI's denoised protein signal. ``inputs`` is ``[rna, protein]``
    (+ the batch one-hot)."""
    pX, _ = self.predict(inputs, batch_size=batch_size)
    y = _as_device_matrix(_flatten(inputs)[1], "cpu")
    with torch.no_grad():
      return pX[1].base.foreground_probability(y).numpy()
