"""SCANVI — semi-supervised single-cell annotation (Xu et al. 2021), port
of ``sisua_tpu/models/scanvi.py``.

  * SCVI's generative model for counts (two encoders, the library prior,
    the log-space decode and the fused-kernel RNA head);
  * a classifier ``q(y|z₁)`` over cell types, read on the z₁ sample (not
    the gene decoder's hidden state), trained on the labeled fraction
    (the semi-supervised mask) with weight ``alpha`` (default 50);
  * a latent hierarchy z₂ → (z₁, y): ``q(z₂|z₁,y)`` and ``p(z₁|z₂,y)``
    replace z₁'s unit-normal prior. Labeled cells evaluate it at their y;
    unlabeled cells marginalize y under ``q(y|z₁)`` and add
    ``KL(q(y|z₁) ‖ Uniform)``: the M1+M2 semi-supervised objective.

The hierarchy is one batched pass over a leading class axis [C, B, ·].
The forward draws twice, as the JAX module calls ``make_rng('sample')``
twice: the latents, then z₂ (its noise is the forward's third ``noise``
entry, of shape [C, B, dz]).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import dist as D
from ..nn import DistributionDense, NetConf, parse_netconf
from ..parallel import functional as PF
from ..rv import RVmeta, parse_rv
from .base import _flatten
from .module import SCVIModule, VAEOutput
from .scvi import SCVI

__all__ = ["SCANVI", "SCANVIModule"]


class SCANVIModule(SCVIModule):
  """SCVI topology + latent classifier + (z₂ | z₁, y) hierarchy.
  ``outputs[1]`` is the 'onehot' cell-type RV; its head reads the
  classifier trunk. ``forward`` puts the per-class penalty
  ``KL(q(z₂|z₁,y)‖N(0,I)) − log p(z₁|z₂,y)``, [C, *batch], in
  ``aux_outputs``."""

  def __init__(self, outputs, latents, encoder_confs, decoder_confs,
               classifier_conf: NetConf, encoder_z2_conf: NetConf,
               decoder_z1_conf: NetConf,
               generator: Optional[torch.Generator] = None, **kwargs):
    # read by _output_in_dim while the base class builds the output heads
    self._classifier_conf = classifier_conf
    super().__init__(outputs, latents, encoder_confs, decoder_confs,
                     generator=generator, **kwargs)
    z_rv = self.latents[0]
    self.classifier = classifier_conf.build(z_rv.dim, generator)
    self.encoder_z2 = encoder_z2_conf.build(z_rv.dim + self.n_labels,
                                            generator)
    self.latent_head_z2 = DistributionDense(
        self.encoder_z2.out_dim, z_rv.replace(name="z2"), generator)
    self.decoder_z1 = decoder_z1_conf.build(z_rv.dim + self.n_labels,
                                            generator)
    self.prior_head_z1 = DistributionDense(
        self.decoder_z1.out_dim, z_rv.replace(name="pz1"), generator)

  @property
  def n_labels(self) -> int:
    return self.outputs[1].dim

  def _output_in_dim(self, i: int) -> int:
    if i == 0:
      return super()._output_in_dim(i)
    units = self._classifier_conf.units
    return units[-1] if units else self.latents[0].dim

  def latent_priors(self, library=None, like=None):
    priors = list(super().latent_priors(library, like))
    priors[0] = None  # z₁'s prior is the hierarchy p(z₁|z₂,y)
    return tuple(priors)

  def _label_heads(self, d, z, generator=None):
    h = self.classifier(z, generator)
    return tuple(head(h) for head in self.output_heads[1:])

  def classify(self, z, generator=None) -> D.Distribution:
    """q(y|z₁) at a latent point (``SCANVI.predict_labels``)."""
    return self._label_heads(None, z, generator)[0]

  def hierarchy_terms(self, z1, generator=None, noise=None) -> torch.Tensor:
    """[C, *batch] penalty of every candidate label, one z₂ draw and the
    analytic z₂ KL, batched over the class axis (the draw's cells follow
    the class axis: a data mesh draws the global batch's there)."""
    C = self.n_labels
    lead = tuple(z1.shape[:-1])
    eye = torch.eye(C, dtype=z1.dtype, device=z1.device)
    z1b = z1.unsqueeze(0).expand((C,) + tuple(z1.shape))
    yb = eye.reshape((C,) + (1,) * len(lead) + (C,)).expand(
        (C,) + lead + (C,))
    qu = self.latent_head_z2(self.encoder_z2(torch.cat([z1b, yb], -1),
                                             generator))
    if noise is None:
      shape = tuple(qu.batch_shape) + tuple(qu.event_shape)
      noise = [PF.draw_rows(lambda s: torch.randn(
          s, generator=generator, device=z1.device, dtype=z1.dtype),
          shape, len(lead))]
    (u,) = self._sample((qu,), (), generator, noise)
    kl_u = D.kl_divergence(qu, self.latents[0].create_prior(
        device=z1.device, dtype=z1.dtype))
    pz1 = self.prior_head_z1(self.decoder_z1(torch.cat([u, yb], -1),
                                             generator))
    return kl_u - pz1.log_prob(z1b)

  def forward(self, x, library=None, sample_shape=(), generator=None,
              noise=None) -> VAEOutput:
    n = len(self.latents)
    out = super().forward(x, library, sample_shape, generator,
                          None if noise is None else noise[:n])
    out.aux_outputs = (self.hierarchy_terms(
        out.latent_samples[0], generator,
        None if noise is None else noise[n:]),)
    return out


class SCANVI(SCVI):
  """Semi-supervised cell-type annotation over SCVI's generative model.
  ``outputs = [rna ('zinbd'|'nbd'), celltype]`` (or ``labels=``); the
  second RV is coerced to a projected 'onehot' over the cell types. The
  data is ``[rna, celltype one-hot]`` (then the batch one-hot under
  ``n_batch``); ``fit(labels_percent=…)`` decides which cells count as
  labeled. ``predict_labels`` gives q(y|z̄₁) at the posterior mean."""

  mask_outputs = True
  module_cls = SCANVIModule
  #: the omics SCANVI supervises (the JAX package's experimenter reads it)
  supervised_omics = ("celltype",)

  def __init__(self,
               outputs,
               labels: Optional[RVmeta] = None,
               classifier=None,
               encoder_z2=None,
               decoder_z1=None,
               alpha: float = 50.0,
               **kwargs):
    outputs = [parse_rv(o, f"output{i}")
               for i, o in enumerate(_flatten(outputs))]
    if labels is not None:
      outputs = [outputs[0], parse_rv(labels, "celltype")]
    if len(outputs) < 2:
      raise ValueError("SCANVI needs the transcriptomic RV plus a cell-type "
                       "label RV (outputs=[rna, celltype] or "
                       "labels=celltype)")
    y = outputs[1]
    if y.posterior != "onehot":
      y = y.replace(posterior="onehot", kwargs=())
    outputs[1] = y.replace(projection=True)
    # a metamodel rebuild passes the assembled *_conf kwargs back in
    if classifier is None:
      classifier = kwargs.pop("classifier_conf",
                              NetConf((32,), dropout=0.1, name="classifier"))
    if encoder_z2 is None:
      encoder_z2 = kwargs.pop("encoder_z2_conf",
                              NetConf((32,), name="encoder_z2"))
    if decoder_z1 is None:
      decoder_z1 = kwargs.pop("decoder_z1_conf",
                              NetConf((32,), name="decoder_z1"))
    super().__init__(outputs, alpha=float(alpha),
                     classifier_conf=parse_netconf(classifier, "classifier"),
                     encoder_z2_conf=parse_netconf(encoder_z2, "encoder_z2"),
                     decoder_z1_conf=parse_netconf(decoder_z1, "decoder_z1"),
                     **kwargs)

  @property
  def n_labels(self) -> int:
    return self.outputs[1].dim

  def _extra_loss(self, out: VAEOutput, batch, training: bool):
    """The hierarchical z₁ term (in place of KL(q(z₁)‖N(0,I)), which the
    zero prior drops), per cell:

      labeled:    log q(z₁|x) + penalty(y)
      unlabeled:  log q(z₁|x) + Σ_y q(y|z₁)·penalty(y) + KL(q(y|z₁)‖U)

    MC sample dims average out. Outside training, or with no mask, every
    cell counts as labeled; a batch without labels marginalizes all. The
    labeled classification term itself is the masked α·log q(y|z₁) of
    output 1 in ``compute_loss``."""
    penalty = torch.movedim(out.aux_outputs[0], 0, -1)      # [*lead, C]
    z1 = out.latent_samples[0]
    lq = out.latents[0].log_prob(z1)                         # [*lead]
    log_qy = F.log_softmax(out.outputs[1].logits, dim=-1)
    qy = torch.exp(log_qy)
    B = z1.shape[-2]
    inputs = batch["inputs"]
    y = inputs[1].to(torch.float32) if len(inputs) > 1 else None
    mask = batch.get("mask")
    if not training or mask is None or y is None:
      m = torch.ones((B,), device=z1.device)
    else:
      m = mask.to(torch.float32).reshape(B)
    if y is None:
      pen_lab = torch.zeros(penalty.shape[:-1], device=z1.device)
      m = torch.zeros((B,), device=z1.device)
    else:
      pen_lab = torch.sum(y * penalty, dim=-1)
    kl_y = torch.sum(qy * (log_qy + math.log(float(self.n_labels))), dim=-1)
    pen_unlab = torch.sum(qy * penalty, dim=-1) + kl_y
    term = lq + m * pen_lab + (1.0 - m) * pen_unlab
    if term.ndim > 1:
      term = term.mean(dim=tuple(range(term.ndim - 1)))
    loss = PF.batch_mean(term)
    return loss, {"klqp_hierarchy": loss, "kl_y": PF.batch_mean(kl_y)}

  def predict_labels(self, data, batch_size: int = 256,
                     hard: bool = False) -> np.ndarray:
    """q(y|z̄₁) at the z₁ posterior mean, (n, n_labels) probabilities, or
    class indices when ``hard``."""
    _, qZ = self.predict(data, batch_size=batch_size)
    z_mean = qZ[0].mean().to(self.device)
    self.module.eval()
    with torch.no_grad():
      probs = self.module.classify(z_mean).probs().cpu().numpy()
    return probs.argmax(-1) if hard else probs
