"""Categorical and OneHotCategorical (port of ``sisua_tpu/dist/discrete.py``):
the 'onehot' label likelihood of the SISUA family."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .base import Distribution, Tensor

__all__ = ["Categorical", "OneHotCategorical"]


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
    return torch.take_along_dim(lp, idx, dim=-1)[..., 0]

  def mean(self):
    k = self.logits.shape[-1]
    return torch.sum(self.probs() * torch.arange(
        k, dtype=self.logits.dtype, device=self.logits.device), -1)

  def sample(self, sample_shape=(), generator=None):
    shape = tuple(sample_shape) + self.batch_shape
    k = self.logits.shape[-1]
    with torch.no_grad():
      p = self.probs().expand(shape + (k,)).reshape(-1, k)
      idx = torch.multinomial(p, 1, generator=generator)
      return idx.reshape(shape)


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
