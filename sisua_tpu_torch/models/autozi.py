"""AUTOZI — per-gene detection of zero inflation (Clivio et al. 2019,
scvi-tools ``AUTOZI``), port of ``sisua_tpu/models/autozi.py``.

Each gene g mixes its ZINB with its own NB at a weight δ_g:
δ·ZINB(π) + (1 − δ)·NB = ZINB(δ·π), so the model is SCVI whose decoded
gate is rescaled per gene (``compose_gate_logits``) and stays one
``ZeroInflated``: the main head keeps the fused kernel route ('loglog' for
``dispersion='full'``). δ_g has a Beta(α_g, β_g) posterior, a Beta(½, ½)
prior, and the KL Σ_g KL(Beta(α, β) ‖ Beta(½, ½)) / N joins the loss as
``klqp_delta``.

Training draws one δ per step, shared by the batch: two log-gamma draws
(log Ga, log Gb) formed into δ = Ga / (Ga + Gb) after scaling both by their
max, as ``jax.random.beta``. The gradient reaches α and β through the
implicit gamma gradient of each draw (``torch._standard_gamma_grad``), as
JAX's; ``torch.distributions.Beta.rsample`` would take the Dirichlet
gradient, which agrees only in expectation. The forward's ``noise`` takes
the pair (log Ga, log Gb) as one more entry after the latents' (the
order JAX calls ``make_rng('sample')``); otherwise they are drawn from the
generator. Evaluation uses the posterior mean α/(α+β).

``get_alphas_betas`` and ``get_zi_probabilities`` return arrays (the port
imports no pandas), where the JAX package may return a pandas Series.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import dist as D
from ..parallel import functional as PF
from ..rv import parse_rv
from .base import _flatten
from .module import NoiseRecorder, SCVIModule, VAEOutput
from .scvi import SCVI

__all__ = ["AUTOZI", "AUTOZIModule", "beta_kl", "compose_gate_logits"]

# Beta(0.5, 0.5): the paper's (and scvi-tools') spike-and-slab prior
PRIOR_ALPHA = 0.5
PRIOR_BETA = 0.5
_LOG_CLIP = 10.0
_DELTA_EPS = 1e-6


def beta_kl(a: torch.Tensor, b: torch.Tensor, a0: float, b0: float
            ) -> torch.Tensor:
  """Analytic KL(Beta(a, b) ‖ Beta(a0, b0)), elementwise."""
  a0 = torch.full_like(a, a0)
  b0 = torch.full_like(b, b0)

  def log_beta_fn(x, y):
    return torch.lgamma(x) + torch.lgamma(y) - torch.lgamma(x + y)

  return (log_beta_fn(a0, b0) - log_beta_fn(a, b)
          + (a - a0) * torch.digamma(a)
          + (b - b0) * torch.digamma(b)
          + (a0 - a + b0 - b) * torch.digamma(a + b))


def compose_gate_logits(log_delta: torch.Tensor,
                        gate_logits: torch.Tensor) -> torch.Tensor:
  """Logits of the gate π' = δ·σ(gate): log π' clamped at −1e-7, then
  log π' − log(−expm1(log π'))."""
  log_pi = torch.clamp_max(log_delta + F.logsigmoid(gate_logits), -1e-7)
  return log_pi - torch.log(-torch.expm1(log_pi))


class _GammaGrad(torch.autograd.Function):
  """∂g/∂a of a draw g ~ Gamma(a, 1) (``torch._standard_gamma_grad``) as
  an operator with a ``vmap`` rule: torch has no batching rule for it, and
  its fallback loops over the members; the op is elementwise, so the rule
  runs it once on the members' stacked tensors."""

  @staticmethod
  def forward(a, g):
    return torch._standard_gamma_grad(a, g)

  @staticmethod
  def setup_context(ctx, inputs, output):
    pass

  @staticmethod
  def backward(ctx, grad):
    raise NotImplementedError("the implicit gamma gradient has no second "
                              "derivative")

  @staticmethod
  def vmap(info, in_dims, a, g):
    a, g = (t.expand(info.batch_size, *t.shape) if d is None
            else t.movedim(d, 0) for t, d in zip((a, g), in_dims))
    return torch._standard_gamma_grad(a, g), 0


class _LogGammaDraw(torch.autograd.Function):
  """log g of a draw g ~ Gamma(a, 1), given, with JAX's ``loggamma``
  gradient d log g / da = (∂g/∂a) / g, g floored at the smallest normal
  float where it underflows. ``torch.func`` transforms take it
  (``VmapEnsemble``'s ``vmap(grad(…))``)."""

  generate_vmap_rule = True

  @staticmethod
  def forward(a, log_g):
    return log_g.clone()

  @staticmethod
  def setup_context(ctx, inputs, output):
    ctx.save_for_backward(*inputs)

  @staticmethod
  def backward(ctx, grad):
    a, log_g = ctx.saved_tensors
    g = torch.exp(log_g)
    g = torch.where(g == 0, torch.finfo(g.dtype).tiny, g)
    return grad * _GammaGrad.apply(a, g) / g, None


def _draw_log_gamma(a: torch.Tensor, generator) -> torch.Tensor:
  """log of a Gamma(a, 1) draw, in log space for a < 1 as JAX's
  ``loggamma``: log Gamma(a + 1) + log(U) / a."""
  boost = a < 1.0
  g = torch._standard_gamma(torch.where(boost, a + 1.0, a),
                            generator=generator)
  u = 1.0 - torch.rand(a.shape, generator=generator, device=a.device,
                       dtype=a.dtype)  # (0, 1]
  return torch.log(g) + torch.where(boost, torch.log(u) / a,
                                    torch.zeros_like(a))


def _stacked_log_gamma_pairs(m, generator, params):
  """δ's (log Ga, log Gb) for M members at once, (M, G) each, each
  member's from its own α, β (``params``: the members' stacked
  parameters, as ``NoiseRecorder`` hands them)."""
  with torch.no_grad():
    a, b = (torch.exp(torch.clamp(params[k], -_LOG_CLIP, _LOG_CLIP))
            for k in ("log_alpha_delta", "log_beta_delta"))
    return _draw_log_gamma(a, generator), _draw_log_gamma(b, generator)


class AUTOZIModule(SCVIModule):
  """SCVI topology plus the per-gene Beta posterior of δ:
  ``log_alpha_delta`` and ``log_beta_delta`` (init 0: Beta(1, 1)), each
  clipped to ±10 before ``exp``."""

  def __init__(self, *args, **kwargs):
    super().__init__(*args, **kwargs)
    n_genes = self.outputs[0].dim
    self.log_alpha_delta = nn.Parameter(torch.zeros(n_genes))
    self.log_beta_delta = nn.Parameter(torch.zeros(n_genes))

  def delta_posterior(self) -> Tuple[torch.Tensor, torch.Tensor]:
    a = torch.exp(torch.clamp(self.log_alpha_delta, -_LOG_CLIP, _LOG_CLIP))
    b = torch.exp(torch.clamp(self.log_beta_delta, -_LOG_CLIP, _LOG_CLIP))
    return a, b

  def sample_delta(self, generator=None, noise=None) -> torch.Tensor:
    """δ clipped to [1e-6, 1 − 1e-6]: a draw in train mode (``noise``: the
    pair (log Ga, log Gb)), the posterior mean otherwise."""
    a, b = self.delta_posterior()
    if self.training:
      if isinstance(noise, NoiseRecorder):
        noise = noise.record(_stacked_log_gamma_pairs,
                             (torch.zeros_like(a), torch.zeros_like(b)))
      if noise is None:
        with torch.no_grad():
          noise = (_draw_log_gamma(a, generator),
                   _draw_log_gamma(b, generator))
      lga = _LogGammaDraw.apply(a, noise[0].to(a))
      lgb = _LogGammaDraw.apply(b, noise[1].to(b))
      log_max = torch.maximum(lga, lgb)
      ga, gb = torch.exp(lga - log_max), torch.exp(lgb - log_max)
      delta = ga / (ga + gb)
    else:
      delta = a / (a + b)
    return torch.clamp(delta, _DELTA_EPS, 1.0 - _DELTA_EPS)

  def decode(self, latent_samples, library=None, generator=None, batch=None,
             noise=None):
    """SCVI's decode with the main head's gate rescaled by δ; ``noise``
    feeds δ's draw."""
    outs = super().decode(latent_samples, library, generator, batch)
    pX = outs[0]
    base = pX.base  # Independent(ZeroInflated(count, gate)) by construction
    log_delta = torch.log(self.sample_delta(generator, noise))
    new = D.Independent(D.ZeroInflated(
        count_distribution=base.count_distribution,
        gate_logits=compose_gate_logits(log_delta, base.gate_logits)),
        pX.reinterpreted_batch_ndims)
    return (new,) + tuple(outs[1:])

  def forward(self, x, library=None, sample_shape=(), generator=None,
              noise=None) -> VAEOutput:
    _, b = self.split_batch(x)
    qZ = self.encode(x, generator)
    n = len(qZ)
    if isinstance(noise, NoiseRecorder):
      delta_noise = noise
    elif noise is None or len(noise) == n:
      delta_noise = None
    elif len(noise) == n + 1:
      delta_noise = noise[n]
    else:
      raise ValueError(f"{len(noise)} noise entries for {n} latents and δ")
    zs = self._sample(qZ, sample_shape, generator,
                      None if noise is None else noise[:n])
    pX = self.decode(zs, library, generator, b, noise=delta_noise)
    return VAEOutput(outputs=pX, latents=qZ, latent_samples=zs,
                     priors=self.latent_priors(library, like=x))


class AUTOZI(SCVI):
  """SCVI with per-gene spike-and-slab zero-inflation detection. The main
  output is coerced to 'zinbd' with per-cell gates (``inflation='full'``);
  ``n_total_cells`` scales the Beta KL (set by ``fit`` from the training
  rows when unset, and then kept on later fits, as in the JAX package)."""

  module_cls = AUTOZIModule

  def __init__(self, outputs, n_total_cells: Optional[int] = None, **kwargs):
    outputs = [parse_rv(o, f"output{i}")
               for i, o in enumerate(_flatten(outputs))]
    if outputs[0].posterior != "zinbd":
      outputs[0] = outputs[0].replace(posterior="zinbd")
    kwargs["inflation"] = "full"
    self._n_total_cells = (None if n_total_cells is None
                           else int(n_total_cells))
    super().__init__(outputs, **kwargs)
    self._init_kwargs_for_save["n_total_cells"] = self._n_total_cells

  @property
  def n_total_cells(self) -> Optional[int]:
    return self._n_total_cells

  def fit(self, train, *args, **kwargs):
    if self._n_total_cells is None:
      n = getattr(train, "n_obs", None)
      if n is None:
        arr = train[0] if isinstance(train, (tuple, list)) else train
        n = arr.shape[0]
      self._n_total_cells = int(n)
      self._init_kwargs_for_save["n_total_cells"] = self._n_total_cells
    return super().fit(train, *args, **kwargs)

  def _extra_loss(self, out: VAEOutput, batch, training: bool):
    """Σ_g KL(Beta(α_g, β_g) ‖ Beta(½, ½)) / N (N = 10,000 when unset)."""
    a, b = self.module.delta_posterior()
    kl = torch.sum(beta_kl(a, b, PRIOR_ALPHA, PRIOR_BETA))
    term = kl / float(self._n_total_cells or 10_000)
    # per gene: every data rank holds it whole
    return PF.replicated(term), {"klqp_delta": term}

  def get_alphas_betas(self, as_numpy: bool = True):
    """Per-gene Beta posterior parameters of δ: ``{'alpha_posterior',
    'beta_posterior'}``, numpy arrays (tensors with ``as_numpy=False``)."""
    with torch.no_grad():
      a, b = self.module.delta_posterior()
    if as_numpy:
      a, b = a.cpu().numpy(), b.cpu().numpy()
    return {"alpha_posterior": a, "beta_posterior": b}

  def get_zi_probabilities(self, var_names=None) -> np.ndarray:
    """Posterior mean P(gene is zero-inflated) = α/(α+β), (n_genes,).
    ``var_names`` is taken for the JAX signature; the port returns the
    array either way."""
    ab = self.get_alphas_betas()
    return ab["alpha_posterior"] / (ab["alpha_posterior"]
                                    + ab["beta_posterior"])
