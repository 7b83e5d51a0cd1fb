"""CellAssign — marker-based probabilistic cell-type assignment (Zhang et
al. 2019; scvi-tools ``CellAssign``), port of
``sisua_tpu/models/cellassign.py``.

Cells are a mixture over C known types with a binary marker matrix
ρ ∈ {0,1}^{G×C}:

    x_ng | c  ~  NB(μ_ngc, θ_g),
    log μ_ngc = log s_n + β_g + δ_gc · ρ_gc,    δ = δ_min + softplus(δ_raw)

with learned type priors π. Direct marginal maximum likelihood: the
(B, G, C) NB log-prob (lgamma-difference form) summed over genes, then a
``logsumexp`` over types; Adam at lr 1e-2 on minibatches whose order comes
from ``np.random.default_rng(seed)``, as in the JAX package. Plain torch:
the JAX package computes this tensor in XLA, outside any Pallas kernel.

Mirrored from the JAX package as they stand there: the shrinkage penalty
falls on ``delta_raw`` (not on δ), and ``predict`` without
``size_factors`` normalizes the size factors over the prediction set.
A marker table given as a DataFrame is read by duck typing (``.columns``,
``.index``, ``.values``); ``predict`` returns the (N, C) array (type names
with ``hard=True``) and ``get_fold_changes`` the (G, C) array, where the
JAX package may return pandas frames.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from .base import _as_device_matrix, resolve_device

__all__ = ["CellAssign"]


def _nb_log_prob(x, log_mu, log_theta):
  """NB(μ, θ) log-pmf, mean/dispersion form, elementwise."""
  theta = torch.exp(log_theta)
  log_theta_mu = torch.logaddexp(log_theta, log_mu)
  return (theta * (log_theta - log_theta_mu)
          + x * (log_mu - log_theta_mu)
          + torch.lgamma(x + theta) - torch.lgamma(theta)
          - torch.lgamma(x + 1.0))


class CellAssign:
  """Assign cells to known types from a binary (genes, types) marker
  matrix; runs on ``device`` (default ``"cuda"``).

  >>> ca = CellAssign(rho, seed=0).fit(x)    # x: (cells, genes) counts
  >>> gamma = ca.predict(x)                   # (cells, types)
  >>> labels = ca.predict(x, hard=True)

  ``min_delta`` floors every marker's log fold-change; ``shrinkage`` is an
  L2 penalty on ``delta_raw``·ρ."""

  def __init__(self, marker_matrix, min_delta: float = 0.5,
               shrinkage: float = 1e-3, seed: int = 0,
               device: Union[str, torch.device] = "cuda"):
    self.celltypes = None
    self.var_names = None
    try:  # a DataFrame: keep the names
      self.celltypes = list(map(str, marker_matrix.columns))
      self.var_names = list(map(str, marker_matrix.index))
      marker_matrix = marker_matrix.values
    except AttributeError:
      pass
    rho = np.asarray(marker_matrix, np.float32)
    if rho.ndim != 2:
      raise ValueError("marker matrix must be (genes, celltypes)")
    if not set(np.unique(rho)) <= {0.0, 1.0}:
      raise ValueError("marker matrix must be binary")
    if (rho.sum(0) > 0).sum() < 1:
      raise ValueError("need at least one marked type")
    self.device = resolve_device(device)
    self.rho = torch.tensor(rho, device=self.device)
    self._background = rho.sum(-1) == 0  # genes marked for no type
    self.n_genes, self.n_types = rho.shape
    self.min_delta = float(min_delta)
    self.shrinkage = float(shrinkage)
    self.seed = int(seed)
    self._params: Optional[Dict[str, torch.Tensor]] = None

  # ------------------------------------------------------------------ math
  def _log_mu(self, params, log_s):
    """(B, G, C) log means: log s_n + β_g + (δ_min + softplus(raw))·ρ."""
    delta = self.min_delta + F.softplus(params["delta_raw"])
    return (log_s[:, None, None] + params["beta"][None, :, None]
            + (delta * self.rho)[None, :, :])

  def _log_gamma(self, params, x, log_s):
    """Unnormalized per-cell log responsibilities (B, C)."""
    lp = _nb_log_prob(x[:, :, None], self._log_mu(params, log_s),
                      params["log_theta"][None, :, None])
    log_pi = F.log_softmax(params["pi_logits"], -1)
    return log_pi[None, :] + torch.sum(lp, dim=1)

  def _neg_llk(self, params, x, log_s):
    marginal = torch.logsumexp(self._log_gamma(params, x, log_s), dim=-1)
    penalty = self.shrinkage * torch.sum(
        (params["delta_raw"] * self.rho) ** 2)
    return -torch.mean(marginal) + penalty

  def _size_factors(self, x: torch.Tensor) -> torch.Tensor:
    """log size factors from the genes marked for no type when at least 3
    are, else from the whole panel, normalized by their mean over ``x``'s
    cells. Transcriptome-wide ``size_factors`` are better when known."""
    bg = self._background
    cols = x[:, torch.as_tensor(bg, device=x.device)] if bg.sum() >= 3 \
        else x
    lib = cols.sum(-1)
    return torch.log(lib / max(float(lib.mean()), 1e-8) + 1e-8)

  def _log_s(self, x, size_factors) -> torch.Tensor:
    if size_factors is None:
      return self._size_factors(x)
    s = (size_factors if isinstance(size_factors, torch.Tensor)
         else torch.as_tensor(np.asarray(size_factors, np.float32)))
    return torch.log(s.to(device=self.device, dtype=torch.float32))

  # ------------------------------------------------------------------ fit
  def fit(self, x, size_factors=None, epochs: int = 150,
          batch_size: int = 512, learning_rate: float = 1e-2,
          verbose: bool = False) -> "CellAssign":
    x = _as_device_matrix(x, self.device)
    if x.shape[1] != self.n_genes:
      raise ValueError(f"X has {x.shape[1]} genes, marker matrix "
                       f"{self.n_genes}")
    log_s = self._log_s(x, size_factors)
    rng = np.random.default_rng(self.seed)
    dev = self.device
    params = {
        # β at the pooled per-gene mean rate (log), δ small, θ at 1
        "beta": torch.log(x.mean(0) + 1e-3),
        "delta_raw": torch.full((self.n_genes, self.n_types), 0.5,
                                device=dev),
        "log_theta": torch.zeros((self.n_genes,), device=dev),
        "pi_logits": torch.zeros((self.n_types,), device=dev),
    }
    params = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    opt = torch.optim.Adam(list(params.values()), lr=learning_rate,
                           betas=(0.9, 0.999), eps=1e-8)
    n = x.shape[0]
    bs = min(batch_size, n)
    steps_per_epoch = max(n // bs, 1)
    self.history = {"loss": []}
    for epoch in range(int(epochs)):
      order = rng.permutation(n)
      losses = []
      for it in range(steps_per_epoch):
        sl = order[it * bs:(it + 1) * bs]
        if sl.shape[0] < bs:
          break
        rows = torch.as_tensor(sl, device=dev)
        opt.zero_grad(set_to_none=True)
        loss = self._neg_llk(params, x[rows], log_s[rows])
        loss.backward()
        opt.step()
        losses.append(loss.detach())
      # one fetch per epoch; summed in float64 as the JAX loop's floats
      ep_loss = sum(float(v) for v in torch.stack(losses).cpu().numpy()) \
          if losses else 0.0
      self.history["loss"].append(ep_loss / steps_per_epoch)
      if verbose and epoch % 20 == 0:
        print(f"[cellassign] epoch {epoch}: {self.history['loss'][-1]:.4f}")
    self._params = {k: v.detach() for k, v in params.items()}
    return self

  # ------------------------------------------------------------- inference
  def predict(self, x, size_factors=None, hard: bool = False,
              batch_size: int = 2048) -> np.ndarray:
    """Per-cell type responsibilities γ (N, C); with ``hard=True`` the
    argmax labels (type names when the marker matrix carried them)."""
    if self._params is None:
      raise RuntimeError("call fit() first")
    x = _as_device_matrix(x, self.device)
    log_s = self._log_s(x, size_factors)
    with torch.no_grad():
      gamma = torch.cat([F.softmax(self._log_gamma(
          self._params, x[s:s + batch_size], log_s[s:s + batch_size]), -1)
          for s in range(0, x.shape[0], batch_size)]).cpu().numpy()
    if hard:
      idx = gamma.argmax(-1)
      if self.celltypes is not None:
        return np.asarray([self.celltypes[i] for i in idx])
      return idx
    return gamma

  def get_fold_changes(self) -> np.ndarray:
    """Fitted marker log fold-changes δ·ρ, (genes, types)."""
    if self._params is None:
      raise RuntimeError("call fit() first")
    delta = self.min_delta + F.softplus(self._params["delta_raw"])
    return (delta * self.rho).cpu().numpy()
