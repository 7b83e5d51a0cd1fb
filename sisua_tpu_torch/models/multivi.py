"""MultiVI — joint RNA + chromatin-accessibility variational inference
(Ashuach et al. 2023, scvi-tools ``MULTIVI``), port of
``sisua_tpu/models/multivi.py``.

  * two experts over one latent space: q_r(z | log1p rna) and
    q_a(z | binarized peaks), each from its own encoder (encoder0 reads the
    genes, encoder1 the peaks, each with the batch block); the joint
    posterior is the weighted average latent, a diag normal with
    μ = Σ w_m μ_m and σ² = Σ w_m² σ_m², floored at 1e-8;
  * the library latent comes from the RNA branch, with SCVI's per-cell
    prior;
  * RNA: SCVI's single-dispersion log-space decode (``RnaScale``, a
    per-gene θ = exp(``px_r_single``) row, ``RnaDropout`` when
    zero-inflated), which reaches the fused ZINB/NB kernels as 'displog';
  * ATAC: PeakVI's composed Bernoulli decode, in plain torch;
  * a Jeffreys penalty ½[KL(q_r‖q_a) + KL(q_a‖q_r)] over the cells with
    both modalities, divided by their count (at least 1), weighted by
    ``modality_penalty`` outside β.

Mosaic data: an all-zero RNA or ATAC row means the cell lacks that
modality. Its likelihood is gated off (``_output_masks``), its expert gets
weight 0 (a cell with neither gets 0.5 each), the library KL is gated by
the RNA mask (``_latent_masks``) and the penalty skips it. The library
statistics still come from the whole RNA matrix, ATAC-only rows included,
as in the JAX package.

Noise: the forward draws z from the joint posterior and l from the
library head, so ``noise`` holds two entries, (z, l); the experts'
"samples" are their means. The experts ride the forward's latents with
``None`` priors (no KL of their own), after the model's two latents.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import dist as D
from ..nn import DistributionDense, NetConf, dense, parse_netconf
from ..parallel import functional as PF
from ..rv import RVmeta, parse_rv
from .base import SingleCellModel, _flatten
from .module import (_LOG_SCALE_FLOOR, VAEModule, VAEOutput,
                     with_library_prior)
from .peakvi import _binarized, _compose_logits, _decoded_probs

__all__ = ["MULTIVI", "MULTIVIModule"]


def _modality_weights(m_r: torch.Tensor, m_a: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
  """(B, 1) expert weights from the observed-modality indicators; a cell
  with neither modality gets an even mix."""
  total = m_r + m_a
  safe = torch.clamp_min(total, 1.0)
  half = torch.full_like(total, 0.5)
  w_r = torch.where(total > 0, m_r / safe, half)
  w_a = torch.where(total > 0, m_a / safe, half)
  return w_r[:, None], w_a[:, None]


def _observed(x: torch.Tensor) -> torch.Tensor:
  """1 where a row holds any count, else 0: (B,)."""
  return (x.sum(-1) > 0).to(torch.float32)


class MULTIVIModule(VAEModule):
  #: torch submodule name → its flax name (``convert`` maps them): the
  #: method ``depth_logit`` owns the name in Python, as in the JAX module
  flax_names = {"depth_head": "depth_logit"}

  """Two-expert module; its input is concat(rna, atac) (then the batch
  block). Submodules and parameters carry the flax names. The experts and
  the RNA and accessibility heads project in the compute dtype."""

  _compute_dtype_layers = ("latent_head_z_rna", "latent_head_z_atac",
                           "RnaScale", "RnaDropout", "AccessibilityScale")

  def __init__(self, outputs, latents, encoder_confs, decoder_confs,
               log_norm: bool = True, reduce_latent: str = "first",
               n_genes: int = 0, n_regions: int = 0,
               clip_library: float = 1e3,
               depth_conf: Optional[NetConf] = None, n_batch: int = 0,
               generator: Optional[torch.Generator] = None):
    if (len(outputs) != 2 or int(n_genes) != outputs[0].dim
        or int(n_regions) != outputs[1].dim):
      raise ValueError(f"MULTIVIModule needs (rna, atac) outputs of widths "
                       f"n_genes={n_genes}, n_regions={n_regions}")
    if len(encoder_confs) != 2 or len(decoder_confs) != 2:
      raise ValueError("MULTIVI builds (rna, atac) encoder/decoder pairs")
    if latents[0].posterior != "diag":
      raise ValueError("MULTIVI's joint posterior needs a 'diag' latent, "
                       f"got {latents[0].posterior!r}")
    super().__init__(outputs, latents, encoder_confs, decoder_confs,
                     log_norm=log_norm, reduce_latent="first",
                     n_batch=n_batch, generator=generator)
    self.n_genes, self.n_regions = int(n_genes), int(n_regions)
    self.clip_library = float(clip_library)
    zrv = self.latents[0]
    self.latent_head_z_rna = DistributionDense(
        self.encoders[0].out_dim, zrv.replace(name="z_rna"), generator)
    self.latent_head_z_atac = DistributionDense(
        self.encoders[1].out_dim, zrv.replace(name="z_atac"), generator)
    d_r, d_a = self.decoders[0].out_dim, self.decoders[1].out_dim
    self.RnaScale = dense(d_r, self.n_genes, generator)
    self.px_r_single = nn.Parameter(torch.zeros(self.n_genes))
    if self.outputs[0].is_zero_inflated:
      self.RnaDropout = dense(d_r, self.n_genes, generator)
    self.region_factor = nn.Parameter(torch.zeros(self.n_regions))
    self.AccessibilityScale = dense(d_a, self.n_regions, generator)
    self.depth_encoder = depth_conf.build(self.n_regions, generator)
    self.depth_head = dense(self.depth_encoder.out_dim, 1, generator)

  # ---- input handling -----------------------------------------------------
  def _main_dim(self) -> int:
    return self.outputs[0].dim + self.outputs[1].dim

  def _encoder_in_dim(self, i: int) -> int:
    return self.outputs[i].dim  # encoder0 the genes, encoder1 the peaks

  def _latent_head_source(self, i: int) -> Optional[int]:
    # z comes from the experts; the library from the RNA branch
    return None if i == 0 else 0

  def _split_modalities(self, x):
    return x[..., :self.n_genes], x[..., self.n_genes:]

  # ---- encode -------------------------------------------------------------
  def encode(self, x, generator=None) -> Tuple[D.Distribution, ...]:
    """(q_joint, q_library, q_rna, q_atac)."""
    x, b = self.split_batch(x)
    rna, atac = self._split_modalities(x)
    h_r = self.encoders[0](self._with_batch(torch.log1p(rna), b), generator)
    h_a = self.encoders[1](self._with_batch(_binarized(atac), b), generator)
    q_r = self.latent_head_z_rna(h_r)
    q_a = self.latent_head_z_atac(h_a)
    q_l = self.latent_heads[1](h_r)
    w_r, w_a = _modality_weights(_observed(rna), _observed(atac))
    mu = w_r * q_r.loc + w_a * q_a.loc
    var = w_r ** 2 * q_r.scale_diag ** 2 + w_a ** 2 * q_a.scale_diag ** 2
    q_joint = D.MultivariateNormalDiag(
        loc=mu, scale_diag=torch.sqrt(torch.clamp_min(var, 1e-8)))
    return q_joint, q_l, q_r, q_a

  def latent_priors(self, library=None, like=None):
    # the experts carry no KL of their own: their alignment cost is the
    # Jeffreys penalty (MULTIVI._extra_loss)
    return with_library_prior(super().latent_priors(library, like),
                              library) + (None, None)

  # ---- decode -------------------------------------------------------------
  def depth_logit(self, x, generator=None) -> torch.Tensor:
    """ℓ_d, (…, 1), from the binarized peaks, through ``depth_head`` (the
    Dense layer flax names ``depth_logit``)."""
    x, _ = self.split_batch(x)
    _, atac = self._split_modalities(x)
    return self.depth_head(self.depth_encoder(_binarized(atac), generator))

  def decode(self, latent_samples, library=None, generator=None, batch=None,
             depth_logit: Optional[torch.Tensor] = None,
             region: bool = True):
    z, l = latent_samples[0], latent_samples[1]
    l = torch.clamp(l, 0.0, self.clip_library)
    zb = self._decoder_input(z, batch)
    d_r = self.decoders[0](zb, generator)
    log_scale = torch.clamp_min(
        F.log_softmax(self.RnaScale(d_r).to(torch.float32), dim=-1),
        _LOG_SCALE_FLOOR)
    nb = D.NegativeBinomialDispLog(log_loc=l + log_scale,
                                   disp=torch.exp(self.px_r_single)[None])
    if self.outputs[0].is_zero_inflated:
      pX = D.Independent(D.ZeroInflated(
          count_distribution=nb,
          gate_logits=self.RnaDropout(d_r).to(torch.float32)), 1)
    else:
      pX = D.Independent(nb, 1)
    d_a = self.decoders[1](zb, generator)
    logits = _compose_logits(self.AccessibilityScale(d_a).to(torch.float32),
                             depth_logit,
                             self.region_factor if region else None)
    return pX, self.output_heads[1](logits)

  def forward(self, x, library=None, sample_shape=(), generator=None,
              noise=None) -> VAEOutput:
    _, b = self.split_batch(x)
    qZ = self.encode(x, generator)
    q_joint, q_l, q_r, q_a = qZ
    z, l = self._sample((q_joint, q_l), sample_shape, generator, noise)
    pX = self.decode((z, l), library, generator, b,
                     depth_logit=self.depth_logit(x, generator))
    return VAEOutput(outputs=pX, latents=qZ,
                     latent_samples=(z, l, q_r.mean(), q_a.mean()),
                     priors=self.latent_priors(library, like=x))


class MULTIVI(SingleCellModel):
  """Joint RNA + ATAC model; outputs = (rna RVmeta, atac RVmeta). The RNA
  posterior must be a count likelihood ('nbd'/'zinbd'/'nb'/'zinb'); the
  ATAC output is coerced to a Bernoulli over binarized peaks. The data is
  ``[rna, atac]`` (then the batch one-hot under ``n_batch``); mix RNA-only,
  ATAC-only and paired cells in one matrix pair (all-zero rows)."""

  module_cls = MULTIVIModule
  n_input_sources = 2  # the encoders read concat(rna, atac)

  def __init__(self,
               outputs,
               latents=None,
               library=None,
               encoder=None,
               depth=None,
               clip_library: float = 1e3,
               modality_penalty: float = 1.0,
               **kwargs):
    outputs = [parse_rv(o, f"output{i}")
               for i, o in enumerate(_flatten(outputs))]
    if len(outputs) != 2:
      raise ValueError("MULTIVI takes exactly (rna, atac) outputs")
    if outputs[0].posterior not in ("zinbd", "nbd", "zinb", "nb"):
      raise ValueError("rna posterior must be a count likelihood, got "
                       f"{outputs[0].posterior}")
    outputs[0] = outputs[0].replace(projection=False)
    outputs[1] = outputs[1].replace(posterior="bernoulli", projection=False,
                                    kwargs=())
    # a metamodel rebuild passes (z, library) back as latents
    if isinstance(latents, (tuple, list)) and len(latents) == 2 \
        and library is None:
      latents, library = latents
    if latents is None:
      latents = RVmeta(16, "diag", True, "latents")
    if library is None:
      library = RVmeta(1, "normal", True, "library")
    encoder = _pair(encoder, (
        NetConf((128, 128), batchnorm=True, dropout=0.1, name="encoder_rna"),
        NetConf((128, 128), batchnorm=True, dropout=0.1,
                name="encoder_atac")), "encoder", "encoder_atac")
    decoder = _pair(kwargs.pop("decoder", None), (
        NetConf((128, 128), batchnorm=True, name="decoder_rna"),
        NetConf((128, 128), batchnorm=True, name="decoder_atac")),
        "decoder", "decoder_atac")
    if depth is None:
      depth = kwargs.pop("depth_conf", NetConf((32,), name="depth"))
    for k in ("reduce_latent", "n_genes", "n_regions"):
      kwargs.pop(k, None)
    super().__init__(tuple(outputs),
                     latents=(parse_rv(latents, "latents"),
                              parse_rv(library, "library")),
                     encoder=encoder, decoder=decoder,
                     reduce_latent="first",
                     n_genes=outputs[0].dim,
                     n_regions=outputs[1].dim,
                     clip_library=float(clip_library),
                     depth_conf=parse_netconf(depth, "depth"),
                     **kwargs)
    self.modality_penalty = float(modality_penalty)
    self._init_kwargs_for_save["modality_penalty"] = self.modality_penalty

  @property
  def uses_library(self) -> bool:
    return True

  def _loss_targets(self, batch):
    targets = list(batch["inputs"])
    targets[1] = _binarized(targets[1])
    return targets

  def _output_masks(self, batch):
    return [_observed(batch["inputs"][0]), _observed(batch["inputs"][1])]

  def _latent_masks(self, batch):
    """The library KL is gated by the RNA mask (it is encoded from the RNA
    branch); the joint z and the experts are not gated."""
    return [None, _observed(batch["inputs"][0]), None, None]

  def _extra_loss(self, out: VAEOutput, batch, training: bool):
    """``modality_penalty`` × the Jeffreys divergence of the two experts,
    averaged over the paired cells of the batch (outside β)."""
    if self.modality_penalty <= 0:
      return None
    q_r, q_a = out.latents[2], out.latents[3]
    jeff = 0.5 * (D.kl_divergence(q_r, q_a) + D.kl_divergence(q_a, q_r))
    m_r, m_a = self._output_masks(batch)
    m = m_r * m_a
    pen = self.modality_penalty * PF.batch_total(
        torch.sum(jeff * m) / torch.clamp_min(PF.batch_sum(m), 1.0))
    return pen, {"modality_penalty": pen}

  def get_accessibility_estimates(self, data, batch_size: int = 256,
                                  region: bool = True) -> np.ndarray:
    """Depth-free accessibility probabilities at the posterior means of
    the joint z and the library, (n, peaks): PeakVI's estimator over the
    joint latent. ``data`` is ``[rna, atac]`` (+ the batch one-hot)."""
    _, qZ = self.predict(data, batch_size=batch_size)
    return _decoded_probs(self, (qZ[0].mean(), qZ[1].mean()), 1, region)


def _pair(confs, default, name: str, second: str):
  """(rna, atac) NetConfs: the default pair, or the given ones, one conf
  standing for both (the second renamed ``second``)."""
  if confs is None:
    return default
  confs = tuple(parse_netconf(c, f"{name}{i}")
                for i, c in enumerate(_flatten(confs)))
  if len(confs) == 1:
    confs = (confs[0], confs[0].replace(name=second))
  return confs
