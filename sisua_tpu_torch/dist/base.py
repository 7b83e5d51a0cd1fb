"""Distribution foundation: small tensor-holding distribution objects.

Port of ``sisua_tpu/dist/base.py``. The JAX package makes every
distribution a pytree so it crosses ``jit``; PyTorch runs eagerly, so here a
distribution is a plain object holding its parameter tensors, and autograd
flows through them. Shape semantics follow TFP as in the reference:
``log_prob(x)`` returns an array of batch shape.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

__all__ = ["Distribution", "Independent", "NoAnalyticKL", "kl_divergence",
           "register_kl", "tree_map", "mc_kl_divergence",
           "concat_distributions", "stack_distributions"]

Tensor = torch.Tensor


class Distribution:
  """Base class: batch/event shapes, ``log_prob``, ``mean``, ``rsample``."""

  @property
  def event_shape(self) -> Tuple[int, ...]:
    return ()

  @property
  def batch_shape(self) -> Tuple[int, ...]:
    raise NotImplementedError

  def log_prob(self, x: Tensor) -> Tensor:
    raise NotImplementedError

  def prob(self, x: Tensor) -> Tensor:
    return torch.exp(self.log_prob(x))

  def mean(self) -> Tensor:
    raise NotImplementedError

  def variance(self) -> Tensor:
    raise NotImplementedError

  def stddev(self) -> Tensor:
    return torch.sqrt(self.variance())

  def mode(self) -> Tensor:
    raise NotImplementedError

  def entropy(self) -> Tensor:
    raise NotImplementedError

  def rsample(self, sample_shape: Tuple[int, ...] = (),
              generator: torch.Generator | None = None,
              eps: Tensor | None = None) -> Tensor:
    """Reparameterized draw. ``eps`` supplies the standard noise directly
    (the parity tests feed the JAX side's noise); otherwise it is drawn
    from ``generator``."""
    raise NotImplementedError

  def sample(self, sample_shape: Tuple[int, ...] = (),
             generator: torch.Generator | None = None) -> Tensor:
    """Draw from ``generator``, outside autograd; families without a
    reparameterization override this."""
    with torch.no_grad():
      return self.rsample(sample_shape, generator=generator)

  def sample_and_log_prob(self, sample_shape: Tuple[int, ...] = (),
                          generator: torch.Generator | None = None):
    """A draw (``sample``) and its log-probability."""
    s = self.sample(sample_shape, generator=generator)
    return s, self.log_prob(s)

  def __getitem__(self, idx) -> "Distribution":
    """Index into the batch dimensions of every parameter tensor."""
    return tree_map(lambda p: p[idx], self)


class Independent(Distribution):
  """Reinterpret the rightmost batch dims of ``base`` as event dims."""

  def __init__(self, base: Distribution, reinterpreted_batch_ndims: int = 1):
    self.base = base
    self.reinterpreted_batch_ndims = int(reinterpreted_batch_ndims)

  @property
  def event_shape(self):
    n = self.reinterpreted_batch_ndims
    bs = self.base.batch_shape
    return tuple(bs[len(bs) - n:]) + tuple(self.base.event_shape)

  @property
  def batch_shape(self):
    bs = self.base.batch_shape
    return tuple(bs[: len(bs) - self.reinterpreted_batch_ndims])

  def log_prob(self, x):
    lp = self.base.log_prob(x)
    return lp.sum(dim=tuple(range(-self.reinterpreted_batch_ndims, 0)))

  def mean(self):
    return self.base.mean()

  def variance(self):
    return self.base.variance()

  def mode(self):
    return self.base.mode()

  def entropy(self):
    ent = self.base.entropy()
    return ent.sum(dim=tuple(range(-self.reinterpreted_batch_ndims, 0)))

  def rsample(self, sample_shape=(), generator=None, eps=None):
    return self.base.rsample(sample_shape, generator=generator, eps=eps)

  def sample(self, sample_shape=(), generator=None):
    return self.base.sample(sample_shape, generator=generator)


def tree_map(fn: Callable[..., Tensor], *dists: Distribution) -> Distribution:
  """A distribution of the first one's type whose parameter tensors are
  ``fn`` of the matching tensors of every argument: the JAX package gets
  this from its distributions being pytrees (``jax.tree_util.tree_map``).
  Nested distributions (``Independent.base``,
  ``ZeroInflated.count_distribution``, a mixture's components) are
  recursed into; every other field is the first argument's."""
  first = dists[0]
  out = object.__new__(type(first))
  for k, v in vars(first).items():
    if isinstance(v, Tensor):
      v = fn(*(vars(d)[k] for d in dists))
    elif isinstance(v, Distribution):
      v = tree_map(fn, *(vars(d)[k] for d in dists))
    setattr(out, k, v)
  return out


# KL registry: analytic where known, else NoAnalyticKL → the caller uses MC
_KL_REGISTRY: Dict[Tuple[type, type], Callable] = {}


def register_kl(p_cls: type, q_cls: type):
  def deco(fn):
    _KL_REGISTRY[(p_cls, q_cls)] = fn
    return fn
  return deco


class NoAnalyticKL(NotImplementedError):
  pass


def kl_divergence(p: Distribution, q: Distribution) -> Tensor:
  """Analytic KL(p ‖ q). Raises NoAnalyticKL when no closed form is known."""
  if isinstance(p, Independent) and isinstance(q, Independent) and (
      p.reinterpreted_batch_ndims == q.reinterpreted_batch_ndims):
    kl = kl_divergence(p.base, q.base)
    return kl.sum(dim=tuple(range(-p.reinterpreted_batch_ndims, 0)))
  for pc in type(p).__mro__:
    for qc in type(q).__mro__:
      fn = _KL_REGISTRY.get((pc, qc))
      if fn is not None:
        return fn(p, q)
  raise NoAnalyticKL(
      f"No analytic KL for {type(p).__name__} ‖ {type(q).__name__}")


def mc_kl_divergence(p: Distribution, q: Distribution,
                     generator: Optional[torch.Generator] = None,
                     n_samples: int = 1) -> Tensor:
  """Monte-Carlo KL(p ‖ q) = E_p[log p − log q] over ``n_samples`` draws of
  p (the JAX package's ``key`` is a generator here)."""
  z = p.sample((n_samples,), generator=generator)
  return torch.mean(p.log_prob(z) - q.log_prob(z), dim=0)


def _structure(d: Distribution):
  """What ``jax.tree_util.tree_structure`` compares: the types, the
  fields, and every field that is not a tensor."""
  return (type(d), tuple(
      (k, _structure(v) if isinstance(v, Distribution)
       else None if isinstance(v, Tensor) else v)
      for k, v in vars(d).items()))


def _tree_join(dists: Sequence[Distribution], join: Callable) -> Distribution:
  if len(dists) == 1:
    return dists[0]
  first = _structure(dists[0])
  for d in dists[1:]:
    if _structure(d) != first:
      raise ValueError("All distributions must share the same structure; "
                       f"got {type(dists[0]).__name__} vs "
                       f"{type(d).__name__}")
  return tree_map(lambda *leaves: join(leaves), *dists)


def concat_distributions(dists: Sequence[Distribution], axis: int = 0
                         ) -> Distribution:
  """Per-minibatch distributions merged along a batch axis."""
  return _tree_join(dists, lambda ls: torch.cat(ls, dim=axis))


def stack_distributions(dists: Sequence[Distribution], axis: int = 0
                        ) -> Distribution:
  return _tree_join(dists, lambda ls: torch.stack(ls, dim=axis))
