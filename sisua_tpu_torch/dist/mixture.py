"""MixtureSameFamily (port of ``sisua_tpu/dist/mixture.py``): the
'mixgaus'/'mdn' and 'mixnb' heads of MISA and the 'mixgaus'/'mixtril'
latents of SCALE.

Component parameters carry the component axis K at position −2, between
batch and event: K Gaussians over a D-dim event have ``loc`` (..., K, D)
and ``mixture_logits`` (..., K). The mixture is not ``Independent``, so the
objective never routes it to the fused likelihood kernels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .base import Distribution, Tensor
from .discrete import Categorical

__all__ = ["MixtureSameFamily"]


class MixtureSameFamily(Distribution):
  """Finite mixture whose ``components`` have batch shape (..., K) and
  reduce their own event dims in ``log_prob``."""

  def __init__(self, mixture_logits: Tensor, components: Distribution):
    self.mixture_logits = mixture_logits
    self.components = components

  @property
  def event_shape(self):
    return self.components.event_shape

  @property
  def batch_shape(self):
    return tuple(self.mixture_logits.shape[:-1])

  @property
  def n_components(self) -> int:
    return self.mixture_logits.shape[-1]

  def _ed(self) -> int:
    return len(self.components.event_shape)

  def _weights(self):
    w = torch.softmax(self.mixture_logits, dim=-1)
    return w.reshape(w.shape + (1,) * self._ed())

  def log_prob(self, x):
    comp_lp = self.components.log_prob(x.unsqueeze(-1 - self._ed()))
    mix_lp = F.log_softmax(self.mixture_logits, dim=-1)
    return torch.logsumexp(mix_lp + comp_lp, dim=-1)

  def mean(self):
    return torch.sum(self._weights() * self.components.mean(),
                     dim=-1 - self._ed())

  def variance(self):
    w, ax = self._weights(), -1 - self._ed()
    m = self.components.mean()
    mix_mean = torch.sum(w * m, dim=ax, keepdim=True)
    return torch.sum(w * (self.components.variance()
                          + torch.square(m - mix_mean)), dim=ax)

  def _pick(self, values, k):
    """``values`` (..., K, *event) at component index ``k`` (...)."""
    ed = self._ed()
    idx = k.reshape(k.shape + (1,) * (1 + ed))
    idx = idx.expand(values.shape[:values.ndim - 1 - ed] + (1,)
                     + values.shape[values.ndim - ed:])
    return torch.take_along_dim(values, idx, dim=-1 - ed).squeeze(-1 - ed)

  def mode(self):
    """The mode of the most probable component."""
    return self._pick(self.components.mode(),
                      torch.argmax(self.mixture_logits, dim=-1))

  def rsample(self, sample_shape=(), generator=None, eps=None):
    """One component index per row from the mixture weights, a
    reparameterized draw from every component, and the picked one's
    (``take_along_dim``). The gradient reaches the picked component's
    parameters, not the mixture logits: those get theirs through
    ``log_prob`` (the Monte-Carlo KL), as in the JAX package. ``eps`` is
    the pair (component indices (…,), component noise (…, K, *event)),
    else both come from ``generator``. A floating-point first entry is
    standard Gumbel noise (…, K) instead of indices: the index is then
    ``argmax(mixture_logits + g)``, ``jax.random.categorical``'s
    Gumbel-max, which ``torch.func.vmap`` can run (``VmapEnsemble``)."""
    if eps is None:
      k = Categorical(self.mixture_logits).sample(sample_shape, generator)
      noise = None
    else:
      k, noise = eps
      shape = tuple(sample_shape) + self.batch_shape
      if k.is_floating_point():
        shape += (self.n_components,)
      if tuple(k.shape) != shape:
        raise ValueError(f"component indices or Gumbel noise of shape "
                         f"{tuple(k.shape)}, expected {shape}")
      if k.is_floating_point():
        k = torch.argmax(self.mixture_logits + k, dim=-1)
      else:
        k = k.to(device=self.mixture_logits.device, dtype=torch.int64)
    draws = self.components.rsample(sample_shape, generator=generator,
                                    eps=noise)
    return self._pick(draws, k)

  def sample(self, sample_shape=(), generator=None):
    """``rsample``'s draw without a gradient, in the same order from
    ``generator``; count components ('mixnb') take their own ``sample``."""
    with torch.no_grad():
      k = Categorical(self.mixture_logits).sample(sample_shape, generator)
      return self._pick(self.components.sample(sample_shape,
                                               generator=generator), k)
