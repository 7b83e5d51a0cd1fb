"""Count likelihoods: NB in four parameterizations and zero-inflation.

Port of ``sisua_tpu/dist/count.py`` for the SCVI slice. The four NB
classes are the four kinds the objective maps onto the fused kernel
(``models/objective.py``): ``NegativeBinomial`` ('logits'),
``NegativeBinomialDisp`` ('disp'), ``NegativeBinomialDispLog`` ('displog')
and ``NegativeBinomialLog`` ('loglog'). All log-probs are elementwise;
``Independent`` sums them per cell.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .base import Distribution, Tensor

__all__ = ["NegativeBinomial", "NegativeBinomialDisp",
           "NegativeBinomialDispLog", "NegativeBinomialLog", "ZeroInflated"]

_EXP_CLIP = 15.0  # rv._EXP_CLIP and ops.zinb._EXP_CLIP


def _lgamma_diff(r, x):
  """lgamma(x + r) − lgamma(r), switching to the asymptotic
  x·log r + x(x−1)/(2r) above r = 1e6, where the float32 difference of two
  ~r·log r values has lost every significant digit."""
  direct = torch.lgamma(x + r) - torch.lgamma(r)
  safe_r = torch.clamp_min(r, 1.0)  # no log(0) in the unselected branch
  asym = x * torch.log(safe_r) + x * (x - 1.0) / (2.0 * safe_r)
  return torch.where(r > 1e6, asym, direct)


def _shape(*ts):
  return tuple(torch.broadcast_shapes(*(torch.as_tensor(t).shape
                                         for t in ts)))


class NegativeBinomial(Distribution):
  """NB over counts of successes before ``total_count`` failures (TFP)."""

  def __init__(self, total_count: Tensor, logits: Tensor):
    self.total_count = total_count
    self.logits = logits

  @property
  def batch_shape(self):
    return _shape(self.total_count, self.logits)

  def log_prob(self, x):
    r, l = self.total_count, self.logits
    return (_lgamma_diff(r, x) - torch.lgamma(x + 1.0)
            + r * F.logsigmoid(-l) + x * F.logsigmoid(l))

  def mean(self):
    return self.total_count * torch.exp(self.logits)


class NegativeBinomialDisp(Distribution):
  """NB with mean/dispersion parameterization (scVI's ``log_nb_positive``)."""

  def __init__(self, loc: Tensor, disp: Tensor):
    self.loc = loc
    self.disp = disp

  @property
  def batch_shape(self):
    return _shape(self.loc, self.disp)

  def log_prob(self, x, eps: float = 1e-8):
    mu, theta = self.loc, self.disp
    log_theta_mu = torch.log(theta + mu + eps)
    # θ·(log θ − log(θ+μ)) as −θ·log1p(μ/θ), with the series −μ for tiny
    # ratios (the two logs are equal in float32 at θ ≥ 1e8)
    ratio = (mu + eps) / (theta + eps)
    theta_term = torch.where(ratio < 1e-6, -(theta + eps) * ratio,
                             -theta * torch.log1p(ratio))
    return (theta_term + x * (torch.log(mu + eps) - log_theta_mu)
            + _lgamma_diff(theta, x) - torch.lgamma(x + 1.0))

  def mean(self):
    return self.loc.expand(self.batch_shape)


class NegativeBinomialDispLog(Distribution):
  """``NegativeBinomialDisp`` with the mean carried in log space (SCVI's
  single-dispersion decode: log μ = log-library + log_softmax(scale))."""

  def __init__(self, log_loc: Tensor, disp: Tensor):
    self.log_loc = log_loc
    self.disp = disp

  @property
  def batch_shape(self):
    return _shape(self.log_loc, self.disp)

  @property
  def loc(self):
    return torch.exp(self.log_loc)

  def log_prob(self, x, eps: float = 1e-8):
    theta = self.disp
    logits = self.log_loc - torch.log(theta + eps)
    sp = F.softplus(logits)
    return (x * logits - (x + theta) * sp
            + _lgamma_diff(theta, x) - torch.lgamma(x + 1.0))

  def mean(self):
    return self.loc.expand(self.batch_shape)


class NegativeBinomialLog(Distribution):
  """NB with both mean and inverse-dispersion in log space (SCVI's 'full'
  dispersion decode). θ = exp(clip(log θ, ±15)); the logits
  L = log μ − log θ use the SAME clipped log θ, so the pmf normalizes for
  |log θ| > 15 too."""

  def __init__(self, log_loc: Tensor, log_disp: Tensor):
    self.log_loc = log_loc
    self.log_disp = log_disp

  @property
  def batch_shape(self):
    return _shape(self.log_loc, self.log_disp)

  @property
  def loc(self):
    return torch.exp(self.log_loc)

  @property
  def disp(self):
    return torch.exp(torch.clamp(self.log_disp, -_EXP_CLIP, _EXP_CLIP))

  def log_prob(self, x):
    ld = torch.clamp(self.log_disp, -_EXP_CLIP, _EXP_CLIP)
    logits = self.log_loc - ld
    theta = torch.exp(ld)
    sp = F.softplus(logits)
    return (x * logits - (x + theta) * sp
            + _lgamma_diff(theta, x) - torch.lgamma(x + 1.0))

  def mean(self):
    return self.loc.expand(self.batch_shape)


class ZeroInflated(Distribution):
  """Zero-inflation wrapper: with prob σ(gate_logits) emit exactly 0."""

  def __init__(self, count_distribution: Distribution, gate_logits: Tensor):
    self.count_distribution = count_distribution
    self.gate_logits = gate_logits

  @property
  def batch_shape(self):
    return tuple(torch.broadcast_shapes(self.count_distribution.batch_shape,
                                        self.gate_logits.shape))

  def log_prob(self, x):
    g = self.gate_logits
    lp = self.count_distribution.log_prob(x)
    lp0 = self.count_distribution.log_prob(torch.zeros_like(x))
    at_zero = torch.logaddexp(F.logsigmoid(g), F.logsigmoid(-g) + lp0)
    return torch.where(x <= 0.0, at_zero, F.logsigmoid(-g) + lp)

  def mean(self):
    return torch.sigmoid(-self.gate_logits) * self.count_distribution.mean()
