"""Posterior helpers of the port (from ``sisua_tpu/analysis/posterior.py``).

``Posterior`` itself, the evaluation hub over a test set, waits for the
port's own clustering and classification scores (ROADMAP A12b: the card
has no sklearn); the callbacks of ``sc_metrics`` use these two helpers.
"""

from __future__ import annotations

import torch

from .. import dist as D


def _dist_mean(dist) -> torch.Tensor:
  """The distribution's mean with its MC sample dims averaged, where it
  lies."""
  m = dist.mean()
  if m.ndim > 2:
    m = m.mean(dim=tuple(range(m.ndim - 2)))
  return m


def _unwrap_imputed(dist):
  """The 'imputed' convention: a zero-inflated output's count
  distribution (its mean without the dropout gate)."""
  base = dist.base if isinstance(dist, D.Independent) else dist
  if isinstance(base, D.ZeroInflated):
    return base.count_distribution
  return base
