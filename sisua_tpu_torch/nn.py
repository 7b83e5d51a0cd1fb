"""NetConf + torch building blocks (port of ``sisua_tpu/nn.py``).

Submodules carry the flax names (``dense{i}``, ``bn{i}``,
``{rv.name}_params``) so a JAX parameter path maps onto a torch
``state_dict`` key by joining with '.' (``convert.py``). Framework
differences handled here:

* flax ``Dense`` kernels are (in, out); ``nn.Linear`` weights are (out, in).
  Initialization mirrors flax's lecun_normal (truncated normal) with zero
  bias, drawn from an explicit generator.
* ``BatchNorm`` reproduces flax's ``nn.BatchNorm(momentum=0.9)`` exactly,
  not ``nn.BatchNorm1d``: see its docstring.
* dropout masks come from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .rv import RVmeta

__all__ = ["NetConf", "MLP", "BatchNorm", "DistributionDense",
           "parse_netconf", "dense"]

_ACTIVATIONS = {
    "relu": F.relu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # flax nn.gelu default
    "elu": F.elu,
    "selu": F.selu,
    "swish": F.silu,
    "silu": F.silu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "softplus": F.softplus,
    "linear": lambda x: x,
}


@dataclasses.dataclass(frozen=True)
class NetConf:
  """Declarative MLP config. ``units`` may be an int (replicated ``nlayers``
  times) or an explicit tuple of layer widths."""

  units: Tuple[int, ...] = (64, 64)
  nlayers: int = 2
  activation: str = "relu"
  batchnorm: bool = False
  dropout: float = 0.0
  input_dropout: float = 0.0
  pyramid: bool = False
  use_conv: bool = False
  kernel_size: int = 5
  compute_dtype: Optional[str] = None
  name: Optional[str] = None

  def __post_init__(self):
    # the JAX fields, so a JAX metamodel.json rebuilds this config; the
    # convolutional trunk and mixed precision are not ported yet
    if self.use_conv:
      raise NotImplementedError("NetConf.use_conv is not ported yet")
    if self.compute_dtype not in (None, "float32"):
      raise NotImplementedError(
          f"NetConf.compute_dtype={self.compute_dtype!r} is not ported yet "
          "(mixed precision)")
    u = self.units
    if isinstance(u, int):
      u = (u,) * max(1, int(self.nlayers))
    else:
      u = tuple(int(x) for x in u)
    if self.pyramid:
      u = tuple(max(8, u[0] // (2 ** i)) for i in range(len(u)))
    object.__setattr__(self, "units", u)
    object.__setattr__(self, "nlayers", len(u))

  def build(self, in_dim: int,
            generator: Optional[torch.Generator] = None) -> "MLP":
    return MLP(in_dim, self, generator)

  def replace(self, **updates) -> "NetConf":
    return dataclasses.replace(self, **updates)


def parse_netconf(x, default_name: str = "net") -> NetConf:
  """YAML/ctor shorthand → NetConf."""
  if isinstance(x, NetConf):
    return x
  if isinstance(x, dict):
    kw = dict(x)
    if "hidden_dim" in kw:  # reference alias
      kw["units"] = kw.pop("hidden_dim")
    kw.setdefault("name", default_name)
    if isinstance(kw.get("units"), list):
      kw["units"] = tuple(kw["units"])
    return NetConf(**kw)
  if isinstance(x, int):
    return NetConf(units=(x,), nlayers=1, name=default_name)
  if isinstance(x, (tuple, list)):
    return NetConf(units=tuple(int(i) for i in x), name=default_name)
  raise TypeError(f"Cannot parse NetConf from {x!r}")


# flax's lecun_normal: variance_scaling(1, 'fan_in', 'truncated_normal');
# the constant is the std of a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def dense(in_dim: int, out_dim: int,
          generator: Optional[torch.Generator] = None) -> nn.Linear:
  """``nn.Linear`` initialized like flax ``nn.Dense``: the kernel from a
  normal truncated to ±2 std by the inverse CDF (one uniform draw per
  weight, so SCScope's 33,000 × 33,000 imputer draws in seconds; torch's
  ``trunc_normal_`` rejects and redraws over the whole tensor), zero bias.
  nn.Linear's own initialization is skipped."""
  lin = torch.nn.utils.skip_init(nn.Linear, in_dim, out_dim)
  std = math.sqrt(1.0 / in_dim) / _TRUNC_STD
  edge = math.erf(2.0 / math.sqrt(2.0))  # 2Φ(2) − 1
  with torch.no_grad():
    lin.weight.uniform_(-edge, edge, generator=generator)
    lin.weight.erfinv_().mul_(std * math.sqrt(2.0))
    lin.weight.clamp_(-2.0 * std, 2.0 * std)
    lin.bias.zero_()
  return lin


class BatchNorm(nn.Module):
  """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the last axis.

  Differs from ``nn.BatchNorm1d`` on purpose, so converted JAX batch stats
  and the port's updates agree:
    * running = 0.9·running + 0.1·batch (flax momentum 0.9 ≡ torch 0.1);
    * the running variance takes the BIASED batch variance, where
      ``nn.BatchNorm1d`` stores the unbiased one;
    * batch variance is flax's fast form E[x²] − E[x]², floored at 0;
    * the buffers are only ``running_mean``/``running_var`` (no
      ``num_batches_tracked``), one-to-one with flax's ``mean``/``var``.
  """

  momentum = 0.9
  epsilon = 1e-5

  def __init__(self, features: int):
    super().__init__()
    self.weight = nn.Parameter(torch.ones(features))   # flax 'scale'
    self.bias = nn.Parameter(torch.zeros(features))
    self.register_buffer("running_mean", torch.zeros(features))
    self.register_buffer("running_var", torch.ones(features))

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    if self.training:
      axes = tuple(range(x.ndim - 1))
      mean = x.mean(dim=axes)
      var = torch.clamp_min((x * x).mean(dim=axes) - mean * mean, 0.0)
      with torch.no_grad():
        m = self.momentum
        self.running_mean.mul_(m).add_((1.0 - m) * mean.detach())
        self.running_var.mul_(m).add_((1.0 - m) * var.detach())
    else:
      mean, var = self.running_mean, self.running_var
    mul = torch.rsqrt(var + self.epsilon) * self.weight
    return (x - mean) * mul + self.bias


def _dropout(x: torch.Tensor, rate: float,
             generator: Optional[torch.Generator]) -> torch.Tensor:
  """flax ``nn.Dropout``: keep with prob 1−rate, scale kept by 1/(1−rate);
  the mask is drawn from ``generator``."""
  keep_prob = 1.0 - rate
  keep = torch.rand(x.shape, generator=generator, device=x.device,
                    dtype=x.dtype) < keep_prob
  return torch.where(keep, x / keep_prob, torch.zeros_like(x))


class MLP(nn.Module):
  """Dense stack with optional batchnorm / dropout / input dropout.
  ``units=()`` is the identity (LDVAE's linear decoder): no parameters,
  ``out_dim`` the input width, input dropout still applied."""

  def __init__(self, in_dim: int, conf: NetConf,
               generator: Optional[torch.Generator] = None):
    super().__init__()
    self.conf = conf
    self.act = _ACTIVATIONS[conf.activation]
    self.out_dim = conf.units[-1] if conf.units else in_dim
    d = in_dim
    for i, u in enumerate(conf.units):
      self.add_module(f"dense{i}", dense(d, u, generator))
      if conf.batchnorm:
        self.add_module(f"bn{i}", BatchNorm(u))
      d = u

  def forward(self, x: torch.Tensor,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    c = self.conf
    if self.training and c.input_dropout > 0:
      x = _dropout(x, c.input_dropout, generator)
    for i in range(len(c.units)):
      x = getattr(self, f"dense{i}")(x)
      if c.batchnorm:
        x = getattr(self, f"bn{i}")(x)
      x = self.act(x)
      if self.training and c.dropout > 0:
        x = _dropout(x, c.dropout, generator)
    return x


class DistributionDense(nn.Module):
  """Dense projection hidden → raw params → Distribution. With
  ``rv.projection=False`` the input is already-constrained flat
  parameters, only packaged, and the module holds no parameters."""

  def __init__(self, in_dim: int, rv: RVmeta,
               generator: Optional[torch.Generator] = None):
    super().__init__()
    self.rv = rv
    if rv.projection:
      self.add_module(f"{rv.name or 'rv'}_params",
                      dense(in_dim, rv.n_params, generator))

  def forward(self, h: torch.Tensor):
    if not self.rv.projection:
      return self.rv.create_distribution(h, constrained=True)
    return self.rv.create_distribution(
        getattr(self, f"{self.rv.name or 'rv'}_params")(h))
