"""Count likelihoods: Poisson, Bernoulli, NB in four parameterizations,
zero-inflation, and TotalVI's element-wise two-component NB mixture.

Port of ``sisua_tpu/dist/count.py``. The four NB classes are the four
kinds the objective maps onto the fused kernel (``models/objective.py``):
``NegativeBinomial`` ('logits'), ``NegativeBinomialDisp`` ('disp'),
``NegativeBinomialDispLog`` ('displog') and ``NegativeBinomialLog``
('loglog'). All log-probs are elementwise; ``Independent`` sums them per
cell. NB(μ, θ) draws (MISA's mixture components) take an explicit
``torch.Generator``, as a Gamma–Poisson mixture.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..parallel import functional as PF
from .base import Distribution, Tensor

__all__ = ["Poisson", "Bernoulli", "NegativeBinomial", "NegativeBinomialDisp",
           "NegativeBinomialDispLog", "NegativeBinomialLog",
           "NegativeBinomialMixture", "ZeroInflated"]

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


def _gamma_poisson(shape, generator, cell_axis, theta, scale):
  """A gamma-Poisson draw at ``shape`` (to which ``theta`` and ``scale``
  broadcast): λ ~ Gamma(θ)·scale, x ~ Poisson(λ), as the JAX samplers;
  on a data mesh the global batch's (its cells on ``cell_axis``)."""
  def gamma_poisson(s, theta, scale):
    lam = torch._standard_gamma(theta.contiguous(),
                                generator=generator) * scale
    return torch.poisson(lam.expand(s).contiguous(), generator=generator)
  with torch.no_grad():
    return PF.draw_rows(gamma_poisson, shape, cell_axis,
                        theta.expand(shape), scale.expand(shape))


class _Draws:
  """``sample`` through the family's ``draw(shape, generator,
  cell_axis)``."""

  def sample(self, sample_shape=(), generator=None):
    return self.draw(tuple(sample_shape) + tuple(self.batch_shape),
                     generator, len(tuple(sample_shape)))


class Poisson(_Draws, Distribution):

  def __init__(self, rate: Tensor):
    self.rate = rate

  @property
  def batch_shape(self):
    return tuple(self.rate.shape)

  def log_prob(self, x):
    # rate 0 at an observed zero is log 1 = 0 with finite gradients (the
    # safe-where form); rate 0 at x > 0 is impossible
    safe_rate = torch.where(self.rate > 0, self.rate,
                            torch.ones_like(self.rate))
    ll = x * torch.log(safe_rate) - self.rate - torch.lgamma(x + 1.0)
    return torch.where((x > 0) & (self.rate == 0),
                       torch.full_like(ll, -float("inf")), ll)

  def mean(self):
    return self.rate

  def draw(self, shape, generator=None, cell_axis: int = 0):
    with torch.no_grad():
      return PF.draw_rows(lambda s, rate: torch.poisson(
          rate.expand(s).contiguous(), generator=generator), shape,
          cell_axis, self.rate.expand(shape))


class Bernoulli(_Draws, Distribution):

  def __init__(self, logits: Tensor):
    self.logits = logits

  @property
  def batch_shape(self):
    return tuple(self.logits.shape)

  def probs(self):
    return torch.sigmoid(self.logits)

  def log_prob(self, x):
    return x * F.logsigmoid(self.logits) + (1.0 - x) * F.logsigmoid(
        -self.logits)

  def mean(self):
    return self.probs()

  def draw(self, shape, generator=None, cell_axis: int = 0):
    with torch.no_grad():
      return PF.draw_rows(lambda s, p: torch.bernoulli(
          p.expand(s).contiguous(), generator=generator), shape, cell_axis,
          self.probs().expand(shape))


class NegativeBinomial(_Draws, Distribution):
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

  def draw(self, shape, generator=None, cell_axis: int = 0):
    """λ ~ Gamma(r)·exp(logits), x ~ Poisson(λ)."""
    return _gamma_poisson(shape, generator, cell_axis, self.total_count,
                          torch.exp(self.logits))


class NegativeBinomialDisp(_Draws, Distribution):
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

  def variance(self):
    return self.loc + torch.square(self.loc) / self.disp

  def mode(self):
    return torch.where(self.disp > 1.0,
                       torch.floor(self.loc * (self.disp - 1.0) / self.disp),
                       torch.zeros(()))

  def draw(self, shape, generator=None, cell_axis: int = 0):
    """λ ~ Gamma(θ)·μ/θ, x ~ Poisson(λ)."""
    return _gamma_poisson(shape, generator, cell_axis, self.disp,
                          self.loc / self.disp)


class NegativeBinomialDispLog(_Draws, Distribution):
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

  def draw(self, shape, generator=None, cell_axis: int = 0):
    """λ ~ Gamma(θ)·exp(log μ − log θ), x ~ Poisson(λ)."""
    return _gamma_poisson(shape, generator, cell_axis, self.disp,
                          torch.exp(self.log_loc - torch.log(self.disp)))


class NegativeBinomialLog(_Draws, Distribution):
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

  def draw(self, shape, generator=None, cell_axis: int = 0):
    """λ ~ Gamma(θ)·exp(log μ − clip(log θ)), x ~ Poisson(λ)."""
    ld = torch.clamp(self.log_disp, -_EXP_CLIP, _EXP_CLIP)
    return _gamma_poisson(shape, generator, cell_axis, torch.exp(ld),
                          torch.exp(self.log_loc - ld))


class NegativeBinomialMixture(Distribution):
  """Element-wise two-component NB mixture (TotalVI's protein likelihood):
  each feature mixes a background NB(μ_b, θ) and a foreground NB(μ_f, θ)
  with σ(``mixing_logits``) = P(background). Unlike ``MixtureSameFamily``
  the mixture is independent per element."""

  def __init__(self, loc_back: Tensor, loc_fore: Tensor, disp: Tensor,
               mixing_logits: Tensor):
    self.loc_back = loc_back
    self.loc_fore = loc_fore
    self.disp = disp
    self.mixing_logits = mixing_logits

  @property
  def batch_shape(self):
    return _shape(self.loc_back, self.loc_fore, self.disp,
                  self.mixing_logits)

  def _components(self):
    return (NegativeBinomialDisp(loc=self.loc_back, disp=self.disp),
            NegativeBinomialDisp(loc=self.loc_fore, disp=self.disp))

  @property
  def mixing_probs(self):
    return torch.sigmoid(self.mixing_logits)

  def _weighted_log_probs(self, x):
    back, fore = self._components()
    return (F.logsigmoid(self.mixing_logits) + back.log_prob(x),
            F.logsigmoid(-self.mixing_logits) + fore.log_prob(x))

  def log_prob(self, x):
    return torch.logaddexp(*self._weighted_log_probs(x))

  def mean(self):
    pi = self.mixing_probs
    return pi * self.loc_back + (1.0 - pi) * self.loc_fore

  def foreground_probability(self, x):
    """Posterior P(foreground | x): TotalVI's denoised protein signal."""
    lb, lf = self._weighted_log_probs(x)
    return torch.exp(lf - torch.logaddexp(lb, lf))

  def variance(self):
    pi = self.mixing_probs
    back, fore = self._components()
    m = self.mean()
    return (pi * (back.variance() + torch.square(self.loc_back - m))
            + (1 - pi) * (fore.variance() + torch.square(self.loc_fore - m)))

  def mode(self):
    back, fore = self._components()
    return torch.where(self.mixing_probs > 0.5, back.mode(), fore.mode())

  def sample(self, sample_shape=(), generator=None):
    # both components are drawn at the MIXTURE's batch shape, so per-protein
    # parameters under per-cell mixing get one draw per cell
    shape = tuple(sample_shape) + self.batch_shape
    axis = len(tuple(sample_shape))
    back, fore = self._components()
    with torch.no_grad():
      b = back.draw(shape, generator, axis)
      f = fore.draw(shape, generator, axis)
      u = PF.draw_rows(lambda s: torch.rand(
          s, generator=generator, device=b.device, dtype=b.dtype),
          shape, axis)
      return torch.where(u < self.mixing_probs, b, f)


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

  def variance(self):
    pi = torch.sigmoid(self.gate_logits)
    m = self.count_distribution.mean()
    v = self.count_distribution.variance()
    return (1.0 - pi) * (v + pi * torch.square(m))

  def mode(self):
    return torch.where(torch.sigmoid(self.gate_logits) > 0.5,
                       torch.zeros(()), self.count_distribution.mode())

  def sample(self, sample_shape=(), generator=None):
    # counts are drawn at the wrapper's batch shape, so a per-cell gate over
    # per-gene counts still gets one count draw per cell
    shape = tuple(sample_shape) + self.batch_shape
    axis = len(tuple(sample_shape))
    with torch.no_grad():
      counts = self.count_distribution.draw(shape, generator, axis)
      u = PF.draw_rows(lambda s: torch.rand(
          s, generator=generator, device=counts.device, dtype=counts.dtype),
          shape, axis)
      return torch.where(u < torch.sigmoid(self.gate_logits),
                         torch.zeros_like(counts), counts)
