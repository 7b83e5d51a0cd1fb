"""SOLO — doublet detection on a trained model's latent space (Bernstein
et al. 2020; scvi-tools ``SOLO``), port of ``sisua_tpu/models/solo.py``.

  1. take a trained model (anything with ``encode``: the SCVI family);
  2. simulate doublets by summing random pairs of observed cells, on the
     data's device, from pair indices drawn with
     ``np.random.default_rng(seed)`` as the JAX package draws them;
  3. embed observed cells and doublets with the frozen encoder: the latent
     posterior mean ⊕ log1p(library), standardized per feature (serving
     math: no kernel is launched);
  4. train a small classifier singlet-vs-doublet (Dense 64 → 32 with ReLU
     and dropout 0.2, then 2 logits; Adam at lr 1e-3), keep the state of
     the best validation loss, and score every observed cell.

The generative model's weights never change. The classifier's layers
carry flax's compact names (``Dense_0``, ``Dense_1``, ``Dense_2``), so
``convert.py`` maps the JAX parameters; its dropout masks come from a
``torch.Generator`` seeded from ``seed``, or are given (``masks=``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..nn import dense
from .base import _as_device_matrix

__all__ = ["SOLO"]

_DROPOUT = 0.2


class _Classifier(nn.Module):
  """flax ``_Classifier``: Dense → relu → dropout per hidden width, then a
  2-way Dense ([singlet, doublet] logits)."""

  def __init__(self, in_dim: int, hidden: Tuple[int, ...] = (64, 32),
               generator: Optional[torch.Generator] = None):
    super().__init__()
    self.hidden = tuple(hidden)
    d = in_dim
    for i, w in enumerate(self.hidden):
      self.add_module(f"Dense_{i}", dense(d, w, generator))
      d = w
    self.add_module(f"Dense_{len(self.hidden)}", dense(d, 2, generator))

  def forward(self, h, generator=None,
              masks: Optional[Sequence[torch.Tensor]] = None):
    """``masks``: one boolean keep-mask per hidden layer (train mode),
    else drawn from ``generator``."""
    keep = 1.0 - _DROPOUT
    for i in range(len(self.hidden)):
      h = F.relu(getattr(self, f"Dense_{i}")(h))
      if self.training:
        m = (torch.rand(h.shape, generator=generator, device=h.device)
             < keep) if masks is None else masks[i].to(h.device)
        h = torch.where(m, h / keep, torch.zeros_like(h))
    return getattr(self, f"Dense_{len(self.hidden)}")(h)


def _simulate_doublets(x: torch.Tensor, n_doublets: int,
                       rng: np.random.Generator) -> torch.Tensor:
  """Sum ``n_doublets`` random distinct cell pairs (scvi-tools'
  ``create_doublets``), the indices drawn as the JAX package draws them;
  the rows are summed where ``x`` lies."""
  n = x.shape[0]
  i = rng.integers(0, n, n_doublets)
  j = rng.integers(0, n - 1, n_doublets)
  j = np.where(j >= i, j + 1, j)  # a distinct partner, uniform over pairs
  i, j = (torch.as_tensor(a, device=x.device) for a in (i, j))
  return x.index_select(0, i) + x.index_select(0, j)


def _nll(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
  return -torch.mean(torch.gather(F.log_softmax(logits, -1), -1,
                                  y[:, None]))


class SOLO:
  """Doublet classifier over a trained model's latent space.

  >>> solo = SOLO.from_scvi_model(scvi)
  >>> solo.fit(x)                        # simulates doublets internally
  >>> proba = solo.predict_doublet_proba(x)   # (n_cells,) P(doublet)

  Runs on the model's device. ``doublet_ratio`` doublets are simulated per
  observed cell (default 2)."""

  def __init__(self, model, hidden: Tuple[int, ...] = (64, 32),
               seed: int = 0):
    self.model = model
    self.hidden = tuple(int(h) for h in hidden)
    self.seed = int(seed)
    self.device = model.device
    self.classifier: Optional[_Classifier] = None
    self._feat_mean = None
    self._feat_std = None

  @classmethod
  def from_scvi_model(cls, model, **kwargs) -> "SOLO":
    """scvi-tools' constructor name; any model with a latent works."""
    return cls(model, **kwargs)

  def _new_classifier(self, in_dim: int) -> _Classifier:
    """A classifier initialized like flax's Dense layers from ``seed``."""
    init = torch.Generator().manual_seed(self.seed)
    return _Classifier(in_dim, self.hidden, init).to(self.device)

  # ---------------------------------------------------------------- embed
  def _embed(self, x: torch.Tensor, batch_size: int = 512) -> np.ndarray:
    """Latent posterior mean ⊕ log1p(library) under the frozen encoder,
    (n, latent + 1) float32 on the host."""
    zs = []
    with torch.no_grad():
      for s in range(0, x.shape[0], batch_size):
        qZ = self.model.encode(x[s:s + batch_size])
        qz = qZ[0] if isinstance(qZ, (tuple, list)) else qZ
        zs.append(qz.mean().float().cpu().numpy())
      log_lib = torch.log1p(x.sum(-1, keepdim=True)).cpu().numpy()
    return np.concatenate([np.concatenate(zs, 0), log_lib], -1)

  # ------------------------------------------------------------------ fit
  def _step(self, clf, opt, h, y, generator=None, masks=None
            ) -> torch.Tensor:
    """One Adam step on the negative log-likelihood of the labels."""
    clf.train()
    opt.zero_grad(set_to_none=True)
    loss = _nll(clf(h, generator, masks), y)
    loss.backward()
    opt.step()
    return loss.detach()

  def fit(self,
          data,
          doublet_ratio: float = 2.0,
          epochs: int = 60,
          batch_size: int = 256,
          learning_rate: float = 1e-3,
          valid_fraction: float = 0.1,
          verbose: bool = False) -> "SOLO":
    """Simulate, embed, standardize, and train the classifier; its best
    state on the validation loss is kept. When the validation rows take
    every row (``n_valid`` ≥ the rows, e.g. few cells at batch 256),
    nothing trains and the classifier keeps its initial state, as in the
    JAX package."""
    x = _as_device_matrix(data, self.device)
    rng = np.random.default_rng(self.seed)
    n_doublets = int(round(doublet_ratio * x.shape[0]))
    doublets = _simulate_doublets(x, n_doublets, rng)
    feats = np.concatenate([self._embed(x), self._embed(doublets)], 0)
    del doublets
    labels = np.concatenate([np.zeros(x.shape[0], np.int64),
                             np.ones(n_doublets, np.int64)])
    # standardize (the log-library column dominates otherwise)
    self._feat_mean = feats.mean(0)
    self._feat_std = feats.std(0) + 1e-6
    feats = (feats - self._feat_mean) / self._feat_std
    perm = rng.permutation(feats.shape[0])
    feats, labels = feats[perm], labels[perm]
    n_valid = max(int(valid_fraction * feats.shape[0]), batch_size) \
        if valid_fraction > 0 else 0
    dev = self.device
    fv, lv = (torch.as_tensor(a[:n_valid], device=dev)
              for a in (feats, labels))
    ft, lt = (torch.as_tensor(a[n_valid:], device=dev)
              for a in (feats, labels))

    clf = self._new_classifier(feats.shape[1])
    opt = torch.optim.Adam(clf.parameters(), lr=learning_rate,
                           betas=(0.9, 0.999), eps=1e-8)
    drop = torch.Generator(device=dev).manual_seed(self.seed)
    steps_per_epoch = max(ft.shape[0] // batch_size, 1)
    best = (np.inf, _state(clf))
    for epoch in range(int(epochs)):
      order = np.random.default_rng(self.seed + 1 + epoch).permutation(
          ft.shape[0])
      for it in range(steps_per_epoch):
        sl = order[it * batch_size:(it + 1) * batch_size]
        if sl.shape[0] < batch_size:
          break
        rows = torch.as_tensor(sl, device=dev)
        self._step(clf, opt, ft[rows], lt[rows], drop)
      if n_valid:
        clf.eval()
        with torch.no_grad():
          vl = float(_nll(clf(fv), lv))
        if vl < best[0]:
          best = (vl, _state(clf))
        if verbose:
          print(f"[solo] epoch {epoch}: valid loss {vl:.4f}")
    if n_valid:
      clf.load_state_dict(best[1])
    self.classifier = clf.eval()
    return self

  # ------------------------------------------------------------- inference
  def predict_doublet_proba(self, data, batch_size: int = 512) -> np.ndarray:
    """P(doublet) per observed cell, shape ``(n_cells,)``."""
    if self.classifier is None:
      raise RuntimeError("call fit() first")
    x = _as_device_matrix(data, self.device)
    feats = (self._embed(x, batch_size) - self._feat_mean) / self._feat_std
    self.classifier.eval()
    with torch.no_grad():
      logits = self.classifier(torch.as_tensor(feats, device=self.device))
      return F.softmax(logits, -1)[:, 1].cpu().numpy()

  def predict(self, data, soft: bool = True, threshold: float = 0.5):
    """Soft probabilities (default) or a boolean is-doublet call at
    ``threshold``."""
    proba = self.predict_doublet_proba(data)
    return proba if soft else proba >= threshold


def _state(module: nn.Module):
  return {k: v.detach().clone() for k, v in module.state_dict().items()}
