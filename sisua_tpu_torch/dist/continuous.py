"""Continuous distributions: Normal, MultivariateNormalDiag,
MultivariateNormalTriL, VectorDeterministic, NonzeroMaskedDeterministic,
Gamma and LogNormal.

Port of part of ``sisua_tpu/dist/continuous.py``: the 'diag' latent
posterior and prior, the 'normal' library posterior and prior and the
components of the 'mixgaus' head, each with log_prob, analytic KL and a
reparameterized ``rsample`` that also accepts given standard noise; the
'tril' posterior and the components of 'mixtril' (no closed-form KL: the
objective takes the Monte-Carlo estimate); and the deterministic
'mse'/'linear'/'relu' head, whose KL to anything is 0, and scScope's
'nzmse' head (``NonzeroMaskedDeterministic``), which scores only the
nonzero entries of its target. ``Gamma`` and ``LogNormal`` draw from an
explicit generator.
"""

from __future__ import annotations

import math

import torch

from ..parallel import functional as PF
from .base import Distribution, Tensor, register_kl

__all__ = ["Normal", "MultivariateNormalDiag", "MultivariateNormalTriL",
           "VectorDeterministic", "NonzeroMaskedDeterministic", "Gamma",
           "LogNormal"]

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def _standard_noise(shape, like: Tensor, generator, eps, cell_axis: int):
  """Given noise, or standard normal noise from ``generator`` (the global
  batch's on a data mesh; ``cell_axis``, after the sample dims)."""
  if eps is not None:
    if tuple(eps.shape) != tuple(shape):
      raise ValueError(f"noise shape {tuple(eps.shape)} != {tuple(shape)}")
    return eps.to(device=like.device, dtype=like.dtype)
  return PF.draw_rows(lambda s: torch.randn(
      s, generator=generator, device=like.device, dtype=like.dtype),
      shape, cell_axis)


class Normal(Distribution):

  def __init__(self, loc: Tensor, scale: Tensor):
    self.loc = loc
    self.scale = scale

  @property
  def batch_shape(self):
    return tuple(torch.broadcast_shapes(self.loc.shape, self.scale.shape))

  def log_prob(self, x):
    z = (x - self.loc) / self.scale
    return -0.5 * z * z - torch.log(self.scale) - _HALF_LOG_2PI

  def mean(self):
    return self.loc.expand(self.batch_shape)

  def variance(self):
    return (self.scale * self.scale).expand(self.batch_shape)

  def mode(self):
    return self.mean()

  def entropy(self):
    return 0.5 + _HALF_LOG_2PI + torch.log(self.scale)

  def rsample(self, sample_shape=(), generator=None, eps=None):
    shape = tuple(sample_shape) + self.batch_shape
    return self.loc + self.scale * _standard_noise(
        shape, self.loc, generator, eps, len(tuple(sample_shape)))


@register_kl(Normal, Normal)
def _kl_normal_normal(p: Normal, q: Normal):
  var_ratio = torch.square(p.scale / q.scale)
  t1 = torch.square((p.loc - q.loc) / q.scale)
  return 0.5 * (var_ratio + t1 - 1.0 - torch.log(var_ratio))


class MultivariateNormalDiag(Distribution):
  """MVN with diagonal covariance — the default latent posterior ('diag')."""

  def __init__(self, loc: Tensor, scale_diag: Tensor):
    self.loc = loc
    self.scale_diag = scale_diag

  @property
  def event_shape(self):
    return (self.loc.shape[-1],)

  @property
  def batch_shape(self):
    return tuple(torch.broadcast_shapes(self.loc.shape[:-1],
                                        self.scale_diag.shape[:-1]))

  def log_prob(self, x):
    z = (x - self.loc) / self.scale_diag
    return torch.sum(-0.5 * z * z - torch.log(self.scale_diag)
                     - _HALF_LOG_2PI, dim=-1)

  def mean(self):
    return self.loc.expand(self.batch_shape + self.event_shape)

  def variance(self):
    return torch.square(self.scale_diag).expand(self.batch_shape
                                                + self.event_shape)

  def mode(self):
    return self.mean()

  def entropy(self):
    return torch.sum(0.5 + _HALF_LOG_2PI + torch.log(self.scale_diag),
                     dim=-1)

  def covariance(self):
    """The (…, D, D) diagonal covariance."""
    return torch.diag_embed(torch.square(self.scale_diag))

  def rsample(self, sample_shape=(), generator=None, eps=None):
    shape = tuple(sample_shape) + self.batch_shape + self.event_shape
    return self.loc + self.scale_diag * _standard_noise(
        shape, self.loc, generator, eps, len(tuple(sample_shape)))


@register_kl(MultivariateNormalDiag, MultivariateNormalDiag)
def _kl_mvndiag_mvndiag(p: MultivariateNormalDiag, q: MultivariateNormalDiag):
  var_ratio = torch.square(p.scale_diag / q.scale_diag)
  t1 = torch.square((p.loc - q.loc) / q.scale_diag)
  return 0.5 * torch.sum(var_ratio + t1 - 1.0 - torch.log(var_ratio), dim=-1)


class MultivariateNormalTriL(Distribution):
  """MVN with a lower-triangular scale ``scale_tril`` (..., D, D): the
  'tril' posterior and the components of 'mixtril'."""

  def __init__(self, loc: Tensor, scale_tril: Tensor):
    self.loc = loc
    self.scale_tril = scale_tril

  @property
  def event_shape(self):
    return (self.loc.shape[-1],)

  @property
  def batch_shape(self):
    return tuple(torch.broadcast_shapes(self.loc.shape[:-1],
                                        self.scale_tril.shape[:-2]))

  def log_prob(self, x):
    """Solve L y = x − loc; log|Σ|^½ = Σ log|diag L|."""
    diff = x - self.loc
    lead = torch.broadcast_shapes(diff.shape[:-1], self.scale_tril.shape[:-2])
    d = self.loc.shape[-1]
    tril = self.scale_tril.expand(lead + (d, d))
    y = torch.linalg.solve_triangular(
        tril, diff.expand(lead + (d,)).unsqueeze(-1), upper=False)[..., 0]
    log_det = torch.sum(torch.log(torch.abs(torch.diagonal(
        self.scale_tril, dim1=-2, dim2=-1))), dim=-1)
    return -0.5 * torch.sum(y * y, dim=-1) - log_det - d * _HALF_LOG_2PI

  def mean(self):
    return self.loc.expand(self.batch_shape + self.event_shape)

  def variance(self):
    return torch.sum(self.scale_tril * self.scale_tril, dim=-1)

  def mode(self):
    return self.mean()

  def rsample(self, sample_shape=(), generator=None, eps=None):
    """loc + L @ eps."""
    shape = tuple(sample_shape) + self.batch_shape + self.event_shape
    eps = _standard_noise(shape, self.loc, generator, eps,
                          len(tuple(sample_shape)))
    return self.loc + torch.matmul(self.scale_tril,
                                   eps.unsqueeze(-1))[..., 0]


class VectorDeterministic(Distribution):
  """Point mass at ``loc`` for the 'mse'/'linear'/'relu' heads:
  ``log_prob`` is minus the MEAN squared error over the event axis, and
  ``rsample`` returns ``loc`` whatever noise it is given (DCA's latent)."""

  def __init__(self, loc: Tensor):
    self.loc = loc

  @property
  def event_shape(self):
    return (self.loc.shape[-1],)

  @property
  def batch_shape(self):
    return tuple(self.loc.shape[:-1])

  def log_prob(self, x):
    return -torch.mean(torch.square(x - self.loc), dim=-1)

  def mean(self):
    return self.loc

  def rsample(self, sample_shape=(), generator=None, eps=None):
    return self.loc.expand(tuple(sample_shape) + tuple(self.loc.shape))


@register_kl(VectorDeterministic, Distribution)
def _kl_deterministic_any(p: VectorDeterministic, q: Distribution):
  # the JAX package's convention: a deterministic latent adds no KL (DCA)
  return torch.zeros(p.batch_shape, dtype=p.loc.dtype, device=p.loc.device)


class NonzeroMaskedDeterministic(VectorDeterministic):
  """The 'nzmse' head (scScope's objective): ``log_prob(x)`` is minus the
  squared error over the entries where ``x > 0``, divided by their count
  (floored at 1, so an all-zero row scores 0). With ``log_space`` the
  error is taken between ``log1p(x)`` and ``loc``, and ``mean``, ``mode``
  and draws are ``expm1(loc)``: counts. Its KL to anything is 0, through
  ``VectorDeterministic``'s rule."""

  def __init__(self, loc: Tensor, log_space: bool = False):
    super().__init__(loc)
    self.log_space = bool(log_space)

  def log_prob(self, x):
    m = (x > 0).to(self.loc.dtype)
    t = torch.log1p(x) if self.log_space else x
    se = torch.square(t - self.loc) * m
    n = torch.clamp_min(torch.sum(m, dim=-1), 1.0)
    return -torch.sum(se, dim=-1) / n

  def mean(self):
    return torch.expm1(self.loc) if self.log_space else self.loc

  def mode(self):
    return self.mean()

  def rsample(self, sample_shape=(), generator=None, eps=None):
    m = self.mean()
    return m.expand(tuple(sample_shape) + tuple(m.shape))


class Gamma(Distribution):
  """Gamma(concentration, rate); ``rsample`` carries torch's implicit
  reparameterization gradient to the concentration."""

  def __init__(self, concentration: Tensor, rate: Tensor):
    self.concentration = concentration
    self.rate = rate

  @property
  def batch_shape(self):
    return tuple(torch.broadcast_shapes(self.concentration.shape,
                                        self.rate.shape))

  def log_prob(self, x):
    a, b = self.concentration, self.rate
    return (a * torch.log(b) + (a - 1.0) * torch.log(x) - b * x
            - torch.lgamma(a))

  def mean(self):
    return self.concentration / self.rate

  def variance(self):
    return self.concentration / torch.square(self.rate)

  def mode(self):
    return torch.clamp_min(self.concentration - 1.0, 0.0) / self.rate

  def rsample(self, sample_shape=(), generator=None, eps=None):
    shape = tuple(sample_shape) + self.batch_shape
    a = self.concentration.expand(shape)
    return torch._standard_gamma(a, generator=generator) / self.rate


class LogNormal(Distribution):

  def __init__(self, loc: Tensor, scale: Tensor):
    self.loc = loc
    self.scale = scale

  @property
  def batch_shape(self):
    return tuple(torch.broadcast_shapes(self.loc.shape, self.scale.shape))

  def log_prob(self, x):
    lx = torch.log(x)
    z = (lx - self.loc) / self.scale
    return -0.5 * z * z - torch.log(self.scale) - _HALF_LOG_2PI - lx

  def mean(self):
    return torch.exp(self.loc + 0.5 * self.scale * self.scale)

  def variance(self):
    s2 = self.scale * self.scale
    return (torch.exp(s2) - 1.0) * torch.exp(2.0 * self.loc + s2)

  def rsample(self, sample_shape=(), generator=None, eps=None):
    shape = tuple(sample_shape) + self.batch_shape
    return torch.exp(self.loc + self.scale * _standard_noise(
        shape, self.loc, generator, eps, len(tuple(sample_shape))))
