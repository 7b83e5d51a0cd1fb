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
* dropout masks come from an explicit ``torch.Generator``, or are given
  (``DropoutMasks`` in the generator's place: ``torch.func.vmap`` cannot
  draw from a generator, so an ensemble draws each member's masks outside
  the transform and feeds them in).
* mixed precision (``compute_dtype='bfloat16'``) follows flax's
  ``dtype=bf16`` rules: parameters stay float32 and are cast per call; a
  Dense or Conv casts its input, kernel and bias to the compute dtype and
  rounds the product before the bias is added (two roundings, as
  ``lax.dot_general`` then ``y += bias``); a layer without a compute dtype
  promotes a bf16 input to float32, as flax's ``promote_dtype`` does;
  BatchNorm reduces its statistics in float32 and rounds only its output.
* ``use_conv``: flax's NWC ``nn.Conv`` (stride 2, 'SAME' padding) on the
  features as a 1-D sequence of one channel, with torch's NCW ``conv1d``
  inside and flax's (W, C) order kept in the final flatten.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .parallel import functional as PF
from .rv import RVmeta

__all__ = ["NetConf", "MLP", "BatchNorm", "Conv1d", "Dense",
           "DistributionDense", "DropoutMasks", "parse_netconf", "dense",
           "resolve_dtype"]

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
    resolve_dtype(self.compute_dtype)  # raises on an unknown name
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


_DTYPES = {None: None, "float32": None, "bfloat16": torch.bfloat16}


def resolve_dtype(name: Optional[str]) -> Optional[torch.dtype]:
  """The compute dtype of a ``compute_dtype`` name: None for float32 (the
  exact path), ``torch.bfloat16`` for 'bfloat16'."""
  if name not in _DTYPES:
    raise ValueError(f"compute_dtype must be None, 'float32' or "
                     f"'bfloat16', got {name!r}")
  return _DTYPES[name]


# flax's lecun_normal: variance_scaling(1, 'fan_in', 'truncated_normal');
# the constant is the std of a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def _lecun_normal_(w: torch.Tensor, fan_in: int,
                   generator: Optional[torch.Generator]) -> None:
  """flax's lecun_normal in place: a normal truncated to ±2 std by the
  inverse CDF (one uniform draw per weight, so SCScope's 33,000 × 33,000
  imputer draws in seconds; torch's ``trunc_normal_`` rejects and redraws
  over the whole tensor)."""
  std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
  edge = math.erf(2.0 / math.sqrt(2.0))  # 2Φ(2) − 1
  with torch.no_grad():
    w.uniform_(-edge, edge, generator=generator)
    w.erfinv_().mul_(std * math.sqrt(2.0))
    w.clamp_(-2.0 * std, 2.0 * std)


def _compute_dtype_of(layer, x: torch.Tensor) -> torch.dtype:
  """A layer's compute dtype, else flax's promotion of its input and
  parameters (a bf16 input to a float32 layer computes in float32)."""
  return layer.compute_dtype or torch.promote_types(x.dtype,
                                                    layer.weight.dtype)


class Dense(nn.Linear):
  """flax ``nn.Dense(dtype=compute_dtype)`` over an ``nn.Linear``'s
  parameters: float32 parameters cast per call (module docstring)."""

  compute_dtype: Optional[torch.dtype] = None

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    dt = _compute_dtype_of(self, x)
    return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


def dense(in_dim: int, out_dim: int,
          generator: Optional[torch.Generator] = None,
          compute_dtype: Optional[str] = None) -> Dense:
  """``Dense`` initialized like flax ``nn.Dense``: a lecun_normal kernel,
  zero bias; nn.Linear's own initialization is skipped."""
  lin = torch.nn.utils.skip_init(Dense, in_dim, out_dim)
  lin.compute_dtype = resolve_dtype(compute_dtype)
  _lecun_normal_(lin.weight, in_dim, generator)
  with torch.no_grad():
    lin.bias.zero_()
  return lin


def same_padding(n: int, k: int, stride: int) -> Tuple[int, int]:
  """flax/lax 'SAME' padding of a width-``n`` axis: the output has
  ⌈n / stride⌉ positions; the low side gets half the total, rounded down."""
  out = -(-n // stride)
  total = max((out - 1) * stride + k - n, 0)
  return total // 2, total - total // 2


class Conv1d(nn.Module):
  """flax ``nn.Conv(features, kernel_size=(k,), strides=(2,))`` with its
  default 'SAME' padding, on NWC inputs (…, W, C) → (…, ⌈W/2⌉, features).
  ``weight`` is torch's (out, in, k); flax's kernel is (k, in, out)
  (``convert.py`` reverses the axes)."""

  stride = 2

  def __init__(self, in_ch: int, out_ch: int, kernel_size: int,
               generator: Optional[torch.Generator] = None,
               compute_dtype: Optional[str] = None):
    super().__init__()
    self.kernel_size = int(kernel_size)
    self.compute_dtype = resolve_dtype(compute_dtype)
    self.weight = nn.Parameter(torch.empty(out_ch, in_ch, self.kernel_size))
    self.bias = nn.Parameter(torch.zeros(out_ch))
    _lecun_normal_(self.weight, in_ch * self.kernel_size, generator)

  def forward(self, h: torch.Tensor) -> torch.Tensor:
    dt = _compute_dtype_of(self, h)
    lead, (w, c) = h.shape[:-2], h.shape[-2:]
    x = h.reshape(-1, w, c).transpose(1, 2).to(dt)   # NWC → NCW
    x = F.pad(x, same_padding(w, self.kernel_size, self.stride))
    y = F.conv1d(x, self.weight.to(dt), stride=self.stride)
    y = y.transpose(1, 2) + self.bias.to(dt)           # NCW → NWC
    return y.reshape(*lead, *y.shape[-2:])


class BatchNorm(nn.Module):
  """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the last axis.

  Differs from ``nn.BatchNorm1d`` on purpose, so converted JAX batch stats
  and the port's updates agree:
    * running = 0.9·running + 0.1·batch (flax momentum 0.9 ≡ torch 0.1);
    * the running variance takes the BIASED batch variance, where
      ``nn.BatchNorm1d`` stores the unbiased one;
    * batch variance is flax's fast form E[x²] − E[x]², floored at 0;
    * the buffers are only ``running_mean``/``running_var`` (no
      ``num_batches_tracked``), one-to-one with flax's ``mean``/``var``;
    * on a data mesh the statistics are the global batch's: Σx, Σx² and
      the count summed over 'data' (``parallel.functional.batch_stats``).
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
    # flax's dtype=bf16: the statistics and the normalization run in
    # float32 on the widened input; only the output is rounded
    out_dtype = x.dtype
    x = x.to(torch.float32)
    if self.training:
      axes = tuple(range(x.ndim - 1))
      mean, mean_sq = PF.batch_stats(x, axes)
      var = torch.clamp_min(mean_sq - mean * mean, 0.0)
      with torch.no_grad():
        m = self.momentum
        self.running_mean.mul_(m).add_((1.0 - m) * mean.detach())
        self.running_var.mul_(m).add_((1.0 - m) * var.detach())
    else:
      mean, var = self.running_mean, self.running_var
    mul = torch.rsqrt(var + self.epsilon) * self.weight
    return ((x - mean) * mul + self.bias).to(out_dtype)


class DropoutMasks:
  """Dropout keep-masks given to a forward in place of its generator, taken
  in the order its dropout layers ask for them. ``specs`` records each
  request's (shape, keep probability); without masks every element is
  kept (a forward run once to learn which masks to draw)."""

  def __init__(self, masks: Optional[Sequence[torch.Tensor]] = None):
    self.masks = None if masks is None else list(masks)
    self.specs = []

  def keep(self, x: torch.Tensor, keep_prob: float) -> torch.Tensor:
    i = len(self.specs)
    self.specs.append((tuple(x.shape), keep_prob))
    if self.masks is None:
      return torch.ones(x.shape, dtype=torch.bool, device=x.device)
    if i >= len(self.masks):
      raise ValueError(f"the forward asked for dropout mask {i + 1} of "
                       f"{len(self.masks)} given")
    return self.masks[i]


def _dropout(x: torch.Tensor, rate: float, generator,
             cell_axis: int = -2) -> torch.Tensor:
  """flax ``nn.Dropout``: keep with prob 1−rate, scale kept by 1/(1−rate)
  in x's dtype; the mask is drawn in float32 from ``generator`` (the same
  masks at every compute dtype; the global batch's on a data mesh, its
  cells on ``cell_axis``), or is the next of ``DropoutMasks``."""
  keep_prob = 1.0 - rate
  if isinstance(generator, DropoutMasks):
    keep = generator.keep(x, keep_prob)
  else:
    keep = PF.draw_rows(lambda s: torch.rand(
        s, generator=generator, device=x.device, dtype=torch.float32),
        x.shape, cell_axis) < keep_prob
  return torch.where(keep, x / keep_prob, torch.zeros_like(x))


class MLP(nn.Module):
  """Dense stack with optional batchnorm / dropout / input dropout, or with
  ``use_conv`` a stack of stride-2 ``Conv1d`` layers over the features as a
  1-D sequence (flattened at the end in flax's (W, C) order).
  ``units=()`` is the identity (LDVAE's linear decoder): no parameters,
  ``out_dim`` the input width, input dropout still applied. With a compute
  dtype the input is cast to it first and the output stays in it."""

  def __init__(self, in_dim: int, conf: NetConf,
               generator: Optional[torch.Generator] = None):
    super().__init__()
    self.conf = conf
    self.act = _ACTIVATIONS[conf.activation]
    self.compute_dtype = resolve_dtype(conf.compute_dtype)
    d, width = in_dim, in_dim
    for i, u in enumerate(conf.units):
      if conf.use_conv:
        self.add_module(f"conv{i}", Conv1d(1 if i == 0 else d, u,
                                           conf.kernel_size, generator,
                                           conf.compute_dtype))
        width = -(-width // Conv1d.stride)
      else:
        self.add_module(f"dense{i}", dense(d, u, generator,
                                           conf.compute_dtype))
      if conf.batchnorm:
        self.add_module(f"bn{i}", BatchNorm(u))
      d = u
    if not conf.units:
      self.out_dim = in_dim
    else:
      self.out_dim = width * d if conf.use_conv else d

  def forward(self, x: torch.Tensor,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    c = self.conf
    if self.compute_dtype is not None:
      x = x.to(self.compute_dtype)
    if self.training and c.input_dropout > 0:
      x = _dropout(x, c.input_dropout, generator)
    layer = "conv" if c.use_conv else "dense"
    cell_axis = -2
    if c.use_conv:
      x = x[..., None]  # NWC, one channel
      cell_axis = -3
    for i in range(len(c.units)):
      x = getattr(self, f"{layer}{i}")(x)
      if c.batchnorm:
        x = getattr(self, f"bn{i}")(x)
      x = self.act(x)
      if self.training and c.dropout > 0:
        x = _dropout(x, c.dropout, generator, cell_axis)
    if c.use_conv:
      x = x.reshape(*x.shape[:-2], -1)
    return x


class DistributionDense(nn.Module):
  """Dense projection hidden → raw params → Distribution. With
  ``rv.projection=False`` the input is already-constrained flat
  parameters, only packaged, and the module holds no parameters. The
  projection runs in the compute dtype; its raw parameters are cast back
  to float32 before the distribution, so log-prob math stays float32."""

  def __init__(self, in_dim: int, rv: RVmeta,
               generator: Optional[torch.Generator] = None,
               compute_dtype: Optional[str] = None):
    super().__init__()
    self.rv = rv
    if rv.projection:
      self.add_module(f"{rv.name or 'rv'}_params",
                      dense(in_dim, rv.n_params, generator, compute_dtype))

  def set_compute_dtype(self, compute_dtype: Optional[str]) -> None:
    if self.rv.projection:
      getattr(self, f"{self.rv.name or 'rv'}_params").compute_dtype = \
          resolve_dtype(compute_dtype)

  def forward(self, h: torch.Tensor):
    if not self.rv.projection:
      return self.rv.create_distribution(h.to(torch.float32),
                                         constrained=True)
    return self.rv.create_distribution(
        getattr(self, f"{self.rv.name or 'rv'}_params")(h).to(torch.float32))
