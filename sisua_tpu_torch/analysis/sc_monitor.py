"""Training monitors: a figure saved every ``freq`` epochs (port of
``sisua_tpu/analysis/sc_monitor.py``).

``SingleCellMonitor`` is a ``SingleCellMetric`` whose ``_score`` makes a
figure and saves it under ``path`` as ``<name>_epoch<NNNN>.png`` (the
epoch count of the model's loss history); it logs no score. Its data
step runs where the served batches lie: each batch is reduced on the
device to what the figure draws (the latent means, the imputed mean), and
``_score`` computes the figure's data there (the latents' 2-D PCA, the
top-variance columns in their row order) before one fetch. A monitor is
a ``Visualizer``: within its ``figure_data()`` block nothing is drawn and
no matplotlib is needed, and the data of each firing is kept under the
file's name.

  * ``LearningCurves``: the loss, ``val_loss``, llk and klqp histories;
  * ``ScatterPlot``: the latent means' 2-D PCA coloured by ``labels``
    (one label per cell, or a one-hot matrix whose argmax names a
    ``label_names`` entry: the JAX monitor's celltype, disease or
    progenitor omic);
  * ``HeatmapPlot``: the original and the imputed mean of the 50
    highest-variance genes, cells ordered by the first of them.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..utils.visualization import Visualizer, _pyplot, fast_scatter
from .posterior import _dist_mean, _unwrap_imputed
from .sc_metrics import SingleCellMetric, _first

__all__ = ["SingleCellMonitor", "LearningCurves", "ScatterPlot",
           "HeatmapPlot"]


class SingleCellMonitor(SingleCellMetric, Visualizer):
  """Figure-emitting callback: subclasses give ``_figure_data`` and
  ``_render``; the figures are saved under ``path``."""

  def __init__(self, path: str, dpi: int = 100, **kwargs):
    super().__init__(**kwargs)
    self.path = path
    self.dpi = int(dpi)
    os.makedirs(path, exist_ok=True)

  def set_model(self, model):
    super().set_model(model)
    if not self._data_only:
      _pyplot()  # no matplotlib: fail before training, not at an epoch

  def _figure_data(self, parts, y_true) -> Optional[dict]:
    raise NotImplementedError

  @staticmethod
  def _render(**data):
    raise NotImplementedError

  def plot(self, y_true, pX, qZ):
    """The figure of whole distributions (None when there is nothing to
    draw)."""
    data = self._figure_data(self._reduce(y_true, pX, qZ), y_true)
    return None if data is None else self._render(**data)

  def _score(self, parts, y_true) -> Dict[str, float]:
    data = self._figure_data(parts, y_true)
    if data is not None:
      epoch = len(self.model.history.get("loss", []))
      stem = f"{self.name}_epoch{epoch:04d}"
      self._draw(stem, data, self._render)
      if not self._data_only:  # saved at once, as each firing is drawn
        fig = self.figures.pop(stem)
        fig.savefig(os.path.join(self.path, f"{stem}.png"), dpi=self.dpi,
                    bbox_inches="tight")
        _pyplot().close(fig)
    return {}


class LearningCurves(SingleCellMonitor):
  """Loss/val_loss + llk/klqp curves (no served batch is needed)."""

  def __init__(self, path: str, keys: Optional[Sequence[str]] = None,
               **kwargs):
    super().__init__(path, **kwargs)
    self.keys = keys

  def _reduce(self, y_true, pX, qZ):
    return []

  def on_epoch_end(self, epoch: int, logs: Dict):
    if self.data is None or (epoch % self.freq) != 0:
      return
    self.call(None, None, None)

  def _figure_data(self, parts, y_true):
    hist = self.model.history
    if not hist:
      return None
    keys = self.keys or [k for k in hist
                         if k.startswith(("loss", "val_loss", "llk", "klqp"))]
    return dict(curves={k: np.asarray(hist[k], np.float64) for k in keys
                        if k in hist})

  @staticmethod
  def _render(curves):
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(7, 4))
    for k, v in curves.items():
      ax.plot(v, label=k, lw=1)
    ax.legend(fontsize=6)
    ax.set_xlabel("epoch")
    return fig


class ScatterPlot(SingleCellMonitor):
  """Latent PCA scatter colored by the cells' labels."""

  def __init__(self, path: str, labels=None,
               label_names: Optional[Sequence[str]] = None, **kwargs):
    super().__init__(path, **kwargs)
    self.labels = labels
    self.label_names = label_names

  def _reduce(self, y_true, pX, qZ):
    return [_first(qZ).mean()]

  def _cell_labels(self):
    if self.labels is None:
      return None
    lab = self.labels
    if isinstance(lab, torch.Tensor):
      lab = lab.detach().cpu().numpy()
    lab = np.asarray(lab)
    if lab.ndim == 2:
      names = (np.asarray(self.label_names) if self.label_names is not None
               else np.arange(lab.shape[1]).astype(str))
      lab = names[np.argmax(lab, 1)]
    return lab

  def _figure_data(self, parts, y_true):
    from .decomposition import PCA
    z = parts[0]
    emb = PCA(2, device=z.device).fit_transform(z) if z.shape[1] > 2 else z
    return dict(emb=emb.cpu().numpy(), labels=self._cell_labels(),
                title=self.name)

  @staticmethod
  def _render(emb, labels, title):
    return fast_scatter(emb, labels=labels, title=title).get_figure()


class HeatmapPlot(SingleCellMonitor):
  """Imputed-vs-original mean-expression heatmap of the 50 genes of
  largest variance, cells ordered by the first of them."""

  def _reduce(self, y_true, pX, qZ):
    return [_dist_mean(_unwrap_imputed(_first(pX)))]

  def _figure_data(self, parts, y_true):
    from ..data.analysis import _colvar32
    imp, org = parts[0], y_true[0]
    if not isinstance(org, torch.Tensor):
      org = torch.as_tensor(np.asarray(org, np.float32), device=imp.device)
    order = torch.as_tensor(np.argsort(-_colvar32(org).cpu().numpy())[:50],
                            device=org.device)
    rows = torch.as_tensor(
        np.argsort(org[:, order[0]].cpu().numpy()), device=org.device)
    return dict(original=torch.log1p(org[:, order][rows]).cpu().numpy(),
                imputed=torch.log1p(imp[:, order][rows]).cpu().numpy())

  @staticmethod
  def _render(original, imputed):
    plt = _pyplot()
    fig, axes = plt.subplots(1, 2, figsize=(10, 4))
    for ax, m, t in ((axes[0], original, "original"),
                     (axes[1], imputed, "imputed")):
      im = ax.imshow(m, aspect="auto", cmap="viridis")
      ax.set_title(t)
      ax.set_yticks([])
      fig.colorbar(im, ax=ax)
    return fig
