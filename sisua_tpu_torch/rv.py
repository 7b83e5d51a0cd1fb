"""RVmeta — declarative random-variable spec (port of ``sisua_tpu/rv.py``).

The vocabulary of SCVI, the paper's models (VAE, SISUA, MISA, DCA) and
SCALE, FactorVAE and LDVAE: 'diag', 'normal', 'tril'/'mvntril', the count
heads 'zinbd', 'nbd', 'zinb', 'nb', 'poisson', 'zip', the label heads
'onehot' and 'bernoulli', the deterministic 'mse'/'linear'/'relu', and the
mixtures 'mixgaus'/'mdn', 'mixtril' and 'mixnb'. The activation conventions
are the JAX package's: positive count parameters use ``exp(clip(raw, -15,
15))``; Normal scales and the diagonal of a lower-triangular scale use
``softplus(raw) + 1e-4``; the packed entries of a triangular scale are in
``tril_indices`` order. scScope's 'nzmse' head is deterministic, 'relu' by
default and scored in ``log1p`` space unless ``log_space=False``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from . import dist as D

__all__ = ["RVmeta", "POSTERIORS", "parse_rv"]

_EXP_CLIP = 15.0
_SCALE_EPS = 1e-4


def _positive(raw: torch.Tensor, kw: Optional[dict] = None) -> torch.Tensor:
  """exp with clipped pre-activation; passes already-positive parameters
  through when ``kw['constrained']`` (SCVI's projection=False decode)."""
  if kw and kw.get("constrained"):
    return raw
  return torch.exp(torch.clamp(raw, -_EXP_CLIP, _EXP_CLIP))


def _soft_scale(raw: torch.Tensor) -> torch.Tensor:
  return F.softplus(raw) + _SCALE_EPS


def _tril_size(d: int) -> int:
  return d * (d + 1) // 2


def _fill_tril(flat: torch.Tensor, d: int) -> torch.Tensor:
  """(..., d(d+1)/2) → (..., d, d) lower-triangular, the entries in
  ``tril_indices`` (row-major) order, the diagonal softplus + 1e-4: the JAX
  package's ``_fill_tril``, term for term."""
  rows, cols = torch.tril_indices(d, d, device=flat.device)
  out = flat.new_zeros(tuple(flat.shape[:-1]) + (d, d))
  out[..., rows, cols] = flat
  diag = _soft_scale(torch.diagonal(out, dim1=-2, dim2=-1))
  eye = torch.eye(d, dtype=flat.dtype, device=flat.device)
  return out * (1.0 - eye) + eye * diag[..., None, :] * eye


POSTERIORS: Dict[str, Any] = {}


def _register(*names):
  def deco(cls):
    for n in names:
      POSTERIORS[n] = cls
    return cls
  return deco


class _Spec:
  deterministic = False
  zero_inflated = False
  binary = False

  @staticmethod
  def n_params(dim: int, kw: dict) -> int:
    raise NotImplementedError

  @staticmethod
  def build(raw, dim: int, kw: dict) -> D.Distribution:
    raise NotImplementedError

  @staticmethod
  def prior(dim: int, kw: dict, device, dtype) -> Optional[D.Distribution]:
    return None


@_register("normal", "gaus", "gaussian")
class _NormalSpec(_Spec):
  @staticmethod
  def n_params(dim, kw):
    return 2 * dim

  @staticmethod
  def build(raw, dim, kw):
    loc, scale = torch.chunk(raw, 2, dim=-1)
    return D.Independent(D.Normal(loc=loc, scale=_soft_scale(scale)), 1)

  @staticmethod
  def prior(dim, kw, device, dtype):
    return D.Independent(
        D.Normal(loc=torch.zeros((dim,), device=device, dtype=dtype),
                 scale=torch.ones((dim,), device=device, dtype=dtype)), 1)


@_register("diag")
class _DiagSpec(_Spec):
  @staticmethod
  def n_params(dim, kw):
    return 2 * dim

  @staticmethod
  def build(raw, dim, kw):
    loc, scale = torch.chunk(raw, 2, dim=-1)
    return D.MultivariateNormalDiag(loc=loc, scale_diag=_soft_scale(scale))

  @staticmethod
  def prior(dim, kw, device, dtype):
    return D.MultivariateNormalDiag(
        loc=torch.zeros((dim,), device=device, dtype=dtype),
        scale_diag=torch.ones((dim,), device=device, dtype=dtype))


@_register("tril", "mvntril")
class _TrilSpec(_Spec):
  @staticmethod
  def n_params(dim, kw):
    return dim + _tril_size(dim)

  @staticmethod
  def build(raw, dim, kw):
    return D.MultivariateNormalTriL(loc=raw[..., :dim],
                                    scale_tril=_fill_tril(raw[..., dim:], dim))

  @staticmethod
  def prior(dim, kw, device, dtype):
    return _DiagSpec.prior(dim, kw, device, dtype)


@_register("nbd")
class _NBDSpec(_Spec):
  @staticmethod
  def n_params(dim, kw):
    return 2 * dim

  @staticmethod
  def build(raw, dim, kw):
    loc, disp = torch.chunk(raw, 2, dim=-1)
    return D.Independent(D.NegativeBinomialDisp(
        loc=_positive(loc, kw), disp=_positive(disp, kw)), 1)


@_register("zinbd")
class _ZINBDSpec(_Spec):
  zero_inflated = True

  @staticmethod
  def n_params(dim, kw):
    return 3 * dim

  @staticmethod
  def build(raw, dim, kw):
    loc, disp, gate = torch.chunk(raw, 3, dim=-1)
    nb = D.NegativeBinomialDisp(loc=_positive(loc, kw),
                                disp=_positive(disp, kw))
    return D.Independent(D.ZeroInflated(count_distribution=nb,
                                        gate_logits=gate), 1)


@_register("nb")
class _NBSpec(_Spec):
  @staticmethod
  def n_params(dim, kw):
    return 2 * dim

  @staticmethod
  def build(raw, dim, kw):
    count, logits = torch.chunk(raw, 2, dim=-1)
    return D.Independent(D.NegativeBinomial(
        total_count=_positive(count, kw), logits=logits), 1)


@_register("zinb")
class _ZINBSpec(_Spec):
  zero_inflated = True

  @staticmethod
  def n_params(dim, kw):
    return 3 * dim

  @staticmethod
  def build(raw, dim, kw):
    count, logits, gate = torch.chunk(raw, 3, dim=-1)
    nb = D.NegativeBinomial(total_count=_positive(count, kw), logits=logits)
    return D.Independent(D.ZeroInflated(count_distribution=nb,
                                        gate_logits=gate), 1)


@_register("poisson", "pois")
class _PoissonSpec(_Spec):
  @staticmethod
  def n_params(dim, kw):
    return dim

  @staticmethod
  def build(raw, dim, kw):
    return D.Independent(D.Poisson(rate=_positive(raw, kw)), 1)


@_register("zip")
class _ZIPSpec(_Spec):
  zero_inflated = True

  @staticmethod
  def n_params(dim, kw):
    return 2 * dim

  @staticmethod
  def build(raw, dim, kw):
    rate, gate = torch.chunk(raw, 2, dim=-1)
    return D.Independent(D.ZeroInflated(
        count_distribution=D.Poisson(rate=_positive(rate, kw)),
        gate_logits=gate), 1)


@_register("onehot")
class _OneHotSpec(_Spec):
  binary = True

  @staticmethod
  def n_params(dim, kw):
    return dim

  @staticmethod
  def build(raw, dim, kw):
    return D.OneHotCategorical(logits=raw)


@_register("bernoulli", "bern")
class _BernoulliSpec(_Spec):
  binary = True

  @staticmethod
  def n_params(dim, kw):
    return dim

  @staticmethod
  def build(raw, dim, kw):
    return D.Independent(D.Bernoulli(logits=raw), 1)


@_register("mse", "linear", "relu")
class _DeterministicSpec(_Spec):
  deterministic = True

  @staticmethod
  def n_params(dim, kw):
    return dim

  @staticmethod
  def build(raw, dim, kw):
    loc = F.relu(raw) if kw.get("activation", "linear") == "relu" else raw
    return D.VectorDeterministic(loc=loc)


@_register("nzmse")
class _NonzeroMSESpec(_Spec):
  """Nonzero-masked MSE (scScope): ``-log_prob(x)`` averages the squared
  error over the observed (x > 0) entries only."""
  deterministic = True

  @staticmethod
  def n_params(dim, kw):
    return dim

  @staticmethod
  def build(raw, dim, kw):
    loc = F.relu(raw) if kw.get("activation", "relu") == "relu" else raw
    return D.NonzeroMaskedDeterministic(
        loc=loc, log_space=bool(kw.get("log_space", True)))


def _n_components(kw) -> int:
  return int(kw.get("n_components", 2))


@_register("mixgaus", "mixgaussian", "mdn")
class _MixGausSpec(_Spec):
  @staticmethod
  def n_params(dim, kw):
    return _n_components(kw) * (2 * dim + 1)

  @staticmethod
  def build(raw, dim, kw):
    k = _n_components(kw)
    lead = tuple(raw.shape[:-1])
    loc = raw[..., :k * dim].reshape(lead + (k, dim))
    scale = raw[..., k * dim:2 * k * dim].reshape(lead + (k, dim))
    comp = D.Independent(D.Normal(loc=loc, scale=_soft_scale(scale)), 1)
    return D.MixtureSameFamily(mixture_logits=raw[..., 2 * k * dim:],
                               components=comp)

  @staticmethod
  def prior(dim, kw, device, dtype):
    return _DiagSpec.prior(dim, kw, device, dtype)


@_register("mixnb")
class _MixNBSpec(_Spec):
  @staticmethod
  def n_params(dim, kw):
    zi = bool(kw.get("zero_inflated", False))
    return _n_components(kw) * ((3 if zi else 2) * dim + 1)

  @staticmethod
  def build(raw, dim, kw):
    k = _n_components(kw)
    zi = bool(kw.get("zero_inflated", False))
    per = (3 if zi else 2) * dim
    body = raw[..., :k * per].reshape(tuple(raw.shape[:-1]) + (k, per))
    nb = D.NegativeBinomialDisp(loc=_positive(body[..., :dim], kw),
                                disp=_positive(body[..., dim:2 * dim], kw))
    if zi:
      nb = D.ZeroInflated(count_distribution=nb,
                          gate_logits=body[..., 2 * dim:])
    return D.MixtureSameFamily(mixture_logits=raw[..., k * per:],
                               components=D.Independent(nb, 1))


@_register("mixtril")
class _MixTrilSpec(_Spec):
  @staticmethod
  def n_params(dim, kw):
    return _n_components(kw) * (dim + _tril_size(dim) + 1)

  @staticmethod
  def build(raw, dim, kw):
    k = _n_components(kw)
    per = dim + _tril_size(dim)
    body = raw[..., :k * per].reshape(tuple(raw.shape[:-1]) + (k, per))
    comp = D.MultivariateNormalTriL(loc=body[..., :dim],
                                    scale_tril=_fill_tril(body[..., dim:], dim))
    return D.MixtureSameFamily(mixture_logits=raw[..., k * per:],
                               components=comp)

  @staticmethod
  def prior(dim, kw, device, dtype):
    return _DiagSpec.prior(dim, kw, device, dtype)


@dataclasses.dataclass(frozen=True)
class RVmeta:
  """Random-variable spec: ``RVmeta(dim, posterior, projection, name)``."""

  dim: int
  posterior: str = "diag"
  projection: bool = True
  name: Optional[str] = None
  kwargs: Tuple[Tuple[str, Any], ...] = ()

  def __post_init__(self):
    if self.posterior not in POSTERIORS:
      raise ValueError(
          f"Unknown posterior '{self.posterior}'. "
          f"Supported by the port: {sorted(set(POSTERIORS))}")
    if isinstance(self.kwargs, dict):
      object.__setattr__(self, "kwargs", tuple(sorted(self.kwargs.items())))
    # 'relu' picks its head activation from the posterior name
    if self.posterior == "relu" and "activation" not in dict(self.kwargs):
      object.__setattr__(
          self, "kwargs", self.kwargs + (("activation", "relu"),))

  @property
  def kw(self) -> dict:
    return dict(self.kwargs)

  @property
  def spec(self) -> type:
    return POSTERIORS[self.posterior]

  @property
  def is_zero_inflated(self) -> bool:
    return self.spec.zero_inflated

  @property
  def is_deterministic(self) -> bool:
    return self.spec.deterministic

  @property
  def is_binary(self) -> bool:
    return self.spec.binary

  @property
  def n_params(self) -> int:
    return self.spec.n_params(self.dim, self.kw)

  def create_distribution(self, raw_params: torch.Tensor,
                          constrained: bool = False) -> D.Distribution:
    """Constrain flat raw params (last axis = n_params) → Distribution;
    ``constrained=True`` skips the positivity activations."""
    kw = dict(self.kw, constrained=True) if constrained else self.kw
    return self.spec.build(raw_params, self.dim, kw)

  def create_prior(self, device=None, dtype=torch.float32
                   ) -> Optional[D.Distribution]:
    return self.spec.prior(self.dim, self.kw, device, dtype)

  def replace(self, **updates) -> "RVmeta":
    return dataclasses.replace(self, **updates)


def parse_rv(x, default_name: str = "rv") -> RVmeta:
  """RVmeta, (dim, posterior[, name]) tuple or {'dim':…} dict → RVmeta."""
  if isinstance(x, RVmeta):
    return x
  if isinstance(x, dict):
    kw = dict(x)
    dim = int(kw.pop("dim"))
    posterior = kw.pop("posterior", "diag")
    name = kw.pop("name", default_name)
    projection = bool(kw.pop("projection", True))
    return RVmeta(dim, posterior, projection, name, tuple(sorted(kw.items())))
  if isinstance(x, (tuple, list)):
    return RVmeta(int(x[0]), x[1] if len(x) > 1 else "diag", True,
                  x[2] if len(x) > 2 else default_name)
  raise TypeError(f"Cannot parse RVmeta from {x!r}")
