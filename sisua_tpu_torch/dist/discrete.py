"""Categorical and OneHotCategorical (port of ``sisua_tpu/dist/discrete.py``):
the 'onehot' label likelihood of the SISUA family."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..parallel import functional as PF
from .base import Distribution, Tensor

__all__ = ["Categorical", "OneHotCategorical"]


def _entropy(logits: Tensor) -> Tensor:
  lp = F.log_softmax(logits, dim=-1)
  return -torch.sum(torch.exp(lp) * lp, dim=-1)


class Categorical(Distribution):
  """Over class indices; ``logits`` is (..., K)."""

  def __init__(self, logits: Tensor):
    self.logits = logits

  @property
  def batch_shape(self):
    return tuple(self.logits.shape[:-1])

  def probs(self):
    return torch.softmax(self.logits, dim=-1)

  def log_prob(self, x):
    lp = F.log_softmax(self.logits, dim=-1)
    idx = x.to(torch.int64)[..., None]
    lead = torch.broadcast_shapes(idx.shape[:-1], lp.shape[:-1])
    return torch.take_along_dim(lp.expand(lead + lp.shape[-1:]),
                                idx.expand(lead + (1,)), dim=-1)[..., 0]

  def mean(self):
    k = self.logits.shape[-1]
    return torch.sum(self.probs() * torch.arange(
        k, dtype=self.logits.dtype, device=self.logits.device), -1)

  def mode(self):
    return torch.argmax(self.logits, dim=-1)

  def entropy(self):
    return _entropy(self.logits)

  def sample(self, sample_shape=(), generator=None):
    """Class indices from ``generator``; on a data mesh the global batch's
    (its probabilities gathered), cells after the sample dims."""
    shape = tuple(sample_shape) + self.batch_shape
    k = self.logits.shape[-1]

    def draw(s, probs):
      idx = torch.multinomial(probs.reshape(-1, k), 1, generator=generator)
      return idx.reshape(s)
    with torch.no_grad():
      return PF.draw_rows(draw, shape, len(tuple(sample_shape)),
                          self.probs().expand(shape + (k,)))


class OneHotCategorical(Distribution):
  """Over one-hot (or soft) label vectors: ``log_prob`` is the inner product
  ⟨x, log softmax(logits)⟩."""

  def __init__(self, logits: Tensor):
    self.logits = logits

  @property
  def event_shape(self):
    return (self.logits.shape[-1],)

  @property
  def batch_shape(self):
    return tuple(self.logits.shape[:-1])

  def probs(self):
    return torch.softmax(self.logits, dim=-1)

  def log_prob(self, x):
    return torch.sum(x * F.log_softmax(self.logits, dim=-1), dim=-1)

  def mean(self):
    return self.probs()

  def sample(self, sample_shape=(), generator=None):
    idx = Categorical(self.logits).sample(sample_shape, generator)
    return F.one_hot(idx, self.logits.shape[-1]).to(self.logits.dtype)

  def variance(self):
    p = self.probs()
    return p * (1.0 - p)

  def mode(self):
    return F.one_hot(torch.argmax(self.logits, -1),
                     self.logits.shape[-1]).to(self.logits.dtype)

  def entropy(self):
    return _entropy(self.logits)
