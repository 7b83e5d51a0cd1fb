"""The plotting layer's base (port of ``sisua_tpu/utils/visualization.py``):
the ``Visualizer`` figure sink and the helper plots.

Every figure of the port is made in two steps. The data step computes
what the figure draws, as numpy arrays, names and numbers, with torch on
the caller's device; the render step draws it with matplotlib on the Agg
backend (and seaborn where the JAX figure uses it), a copy of the JAX
render code. matplotlib is imported only by a render step, so the data
steps run on a machine without it, and a render without it raises
``ImportError`` naming the library. ``Visualizer.figure_data()`` runs a
figure method's data step alone: within the block the figures' data is
kept under the figures' names, in their order, and nothing is drawn.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

__all__ = [
    "Visualizer", "fast_scatter", "plot_evaluate_classifier",
    "plot_evaluate_regressor", "plot_evaluate_reconstruction",
    "save_figures", "to_axis", "downsample_data", "show_image",
]


def _pyplot():
  """matplotlib's pyplot on the Agg backend, or ``ImportError`` naming
  matplotlib."""
  try:
    import matplotlib
  except ImportError as e:
    raise ImportError("rendering a figure needs matplotlib, which is not "
                      "installed; the figures' data steps "
                      "(Visualizer.figure_data) run without it") from e
  matplotlib.use("Agg")
  import matplotlib.pyplot as plt
  return plt


def _seaborn():
  """seaborn (after matplotlib), or ``ImportError`` naming the library."""
  _pyplot()
  try:
    import seaborn
  except ImportError as e:
    raise ImportError("this figure is drawn with seaborn, which is not "
                      "installed") from e
  return seaborn


def _host(a) -> np.ndarray:
  if isinstance(a, torch.Tensor):
    return a.detach().cpu().numpy()
  return np.asarray(a)


def _tensor(a, device=None, dtype=None) -> torch.Tensor:
  """``a`` as a tensor on ``device`` (a tensor's own device when None)."""
  if isinstance(a, torch.Tensor):
    t = a
  else:
    if hasattr(a, "toarray"):
      a = a.toarray()
    t = torch.as_tensor(np.asarray(a))
  return t.to(device=device if device is not None else t.device,
              dtype=dtype if dtype is not None else t.dtype)


def to_axis(ax=None, fig_size=(8, 6)):
  if ax is None:
    plt = _pyplot()
    fig = plt.figure(figsize=fig_size)
    ax = fig.add_subplot(111)
  return ax


class Visualizer:
  """Figure sink: accumulate named figures, save them all at once."""

  @property
  def figures(self) -> Dict[str, object]:
    if not hasattr(self, "_figures"):
      self._figures: Dict[str, object] = {}
    return self._figures

  def add_figure(self, name: str, fig) -> "Visualizer":
    plt = _pyplot()
    old = self.figures.get(name)
    if old is not None and old is not fig:
      plt.close(old)  # replacing a name must not leak the old canvas
    self.figures[name] = fig
    # detached from pyplot's registry: the sink keeps the figure alive and
    # fig.savefig renders through its Agg canvas
    plt.close(fig)
    return self

  def save_figures(self,
                   path: str,
                   dpi: int = 120,
                   separate_files: bool = True,
                   clear_figures: bool = True,
                   verbose: bool = False) -> "Visualizer":
    plt = _pyplot()
    if separate_files:
      os.makedirs(path, exist_ok=True)
      for name, fig in self.figures.items():
        fp = os.path.join(path, f"{name}.png")
        fig.savefig(fp, dpi=dpi, bbox_inches="tight")
        if verbose:
          print("saved:", fp)
    else:  # single pdf
      from matplotlib.backends.backend_pdf import PdfPages
      os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
      with PdfPages(path) as pdf:
        for fig in self.figures.values():
          pdf.savefig(fig)
      if verbose:
        print("saved:", path)
    if clear_figures:
      for fig in self.figures.values():
        plt.close(fig)
      self.figures.clear()
    return self

  # ------------------------------------------------- data step / render step
  @contextlib.contextmanager
  def figure_data(self):
    """Within the block the figure methods run their data steps only:
    each figure's data (arrays, names, numbers) goes into the yielded
    dict under the figure's name, in the order the figures would be
    added, and nothing is rendered (no matplotlib is needed)."""
    prev = getattr(self, "_fig_data", None)
    self._fig_data = {}
    try:
      yield self._fig_data
    finally:
      self._fig_data = prev

  @property
  def _data_only(self) -> bool:
    return getattr(self, "_fig_data", None) is not None

  def _draw(self, name: str, data: dict, render) -> "Visualizer":
    """Keep ``data`` under ``name`` (data mode), or render it and add the
    figure."""
    if self._data_only:
      self._fig_data[name] = data
    else:
      self.add_figure(name, render(**data))
    return self

  def _take(self, child: "Visualizer", run, rename=None):
    """Run ``run()``, a figure method of ``child``, in this sink's mode,
    and move its figures (or their data) here, named by ``rename(name)``
    when given."""
    rename = rename or (lambda k: k)
    if self._data_only:
      with child.figure_data() as d:
        run()
      for k, v in d.items():
        self._fig_data[rename(k)] = v
    else:
      run()
      for k, fig in child.figures.items():
        self.add_figure(rename(k), fig)
      child.figures.clear()
    return self


def save_figures(figures: Dict[str, object], path: str, dpi: int = 120):
  v = Visualizer()
  for k, f in figures.items():
    v.add_figure(k, f)
  v.save_figures(path, dpi=dpi)


def downsample_data(*X, max_samples: int = 8000, seed: int = 87654321):
  """Every array cut to ≤ ``max_samples`` rows by one shared seeded choice
  (``RandomState(seed).choice``, the JAX rows bitwise); None entries pass
  through. Tensors are indexed where they lie."""
  sizes = {x.shape[0] for x in X if x is not None}
  if len(sizes) != 1:
    raise ValueError("Inconsistent shape[0] across inputs")
  n = sizes.pop()
  if n <= max_samples:
    return tuple(X)
  ids = np.random.RandomState(seed).choice(n, max_samples, replace=False)

  def take(x):
    if isinstance(x, torch.Tensor):
      return x[torch.as_tensor(ids, device=x.device)]
    return x[ids]
  return tuple(None if x is None else take(x) for x in X)


def _show_image_data(x, is_probability: bool = False) -> dict:
  """A vector or matrix as the image ``show_image`` draws: made square,
  4×4 max-pooled when it has more than 32 rows."""
  from .others import anything2image
  x = np.asarray(anything2image(_host(x)), np.float32)
  if x.ndim == 2 and x.shape[0] > 32:
    h, w = (x.shape[0] // 4) * 4, (x.shape[1] // 4) * 4
    t = torch.as_tensor(x[:h, :w])
    x = t.reshape(h // 4, 4, w // 4, 4).amax(dim=(1, 3)).numpy()
  return dict(x=x, is_probability=is_probability)


def show_image(x: np.ndarray, is_probability: bool = False, ax=None):
  """Render a vector/matrix as a grayscale image, 4×4 max-pooled when
  large."""
  d = _show_image_data(x, is_probability)
  plt = _pyplot()
  ax = to_axis(ax)
  ax.imshow(d["x"], interpolation="nearest", cmap=plt.cm.Greys_r,
            vmin=0.0 if is_probability else None,
            vmax=1.0 if is_probability else None)
  ax.set_xticks([])
  ax.set_yticks([])
  ax.set_aspect(aspect="auto")
  return ax


def fast_scatter(x: np.ndarray,
                 y: Optional[np.ndarray] = None,
                 labels: Optional[Sequence] = None,
                 title: str = "",
                 ax=None,
                 size: int = 8,
                 fig_size=(8, 6)):
  """2-D scatter colored by (categorical) labels: a tab20 colour per
  label, in the order of the sorted unique labels."""
  plt = _pyplot()
  ax = to_axis(ax, fig_size)
  x = _host(x)
  if y is None:
    x, y = x[:, 0], x[:, 1]
  y = _host(y)
  if labels is None:
    ax.scatter(x, y, s=size, alpha=0.6, linewidths=0)
  else:
    labels = np.asarray(labels)
    uniq = np.unique(labels)
    cmap = plt.get_cmap("tab20", len(uniq))
    for i, u in enumerate(uniq):
      m = labels == u
      ax.scatter(x[m], y[m], s=size, alpha=0.6, linewidths=0,
                 color=cmap(i), label=str(u))
    if len(uniq) <= 20:
      ax.legend(fontsize=6, markerscale=2, loc="best")
  ax.set_title(title, fontsize=10)
  ax.set_xticks([])
  ax.set_yticks([])
  return ax


def _classifier_data(y_pred, y_true, labels, device) -> dict:
  """Per-class F1 of the predictions binarized at 0.5 (the port's
  ``f1_score`` on ``device``)."""
  from ..analysis.estimators import f1_score
  yp = _tensor(y_pred, device) > 0.5
  yt = _tensor(y_true, device) > 0.5
  f1s = [f1_score(yt[:, i], yp[:, i], device=device)
         for i in range(yt.shape[1])]
  return dict(f1s=f1s, labels=[str(l) for l in labels])


def plot_evaluate_classifier(y_pred: np.ndarray,
                             y_true: np.ndarray,
                             labels: Sequence[str],
                             title: str = "",
                             return_figure: bool = False,
                             device="cuda"):
  """Per-class F1 bar chart; returns {label: F1} (and the figure)."""
  d = _classifier_data(y_pred, y_true, labels, device)
  f1s = d["f1s"]
  plt = _pyplot()
  fig, ax = plt.subplots(figsize=(max(6, 0.5 * len(labels)), 4))
  ax.bar(range(len(labels)), f1s)
  ax.set_xticks(range(len(labels)))
  ax.set_xticklabels([str(l) for l in labels], rotation=45, fontsize=7,
                     ha="right")
  ax.set_ylabel("F1")
  ax.set_ylim(0, 1)
  ax.set_title(f"{title} (mean F1={np.mean(f1s):.3f})")
  fig.tight_layout()
  scores = dict(zip(map(str, labels), f1s))
  if return_figure:
    return scores, fig
  plt.close(fig)
  return scores


def _regressor_data(y_pred, y_true) -> dict:
  """Each column's R² (float64 sums where the arrays lie)."""
  yt = _tensor(y_true, dtype=torch.float64)
  yp = _tensor(y_pred, yt.device, torch.float64)
  ss_res = ((yt - yp) ** 2).sum(0)
  ss_tot = ((yt - yt.mean(0)) ** 2).sum(0) + 1e-12
  return dict(r2=_host(1 - ss_res / ss_tot), y_true=_host(y_true),
              y_pred=_host(y_pred))


def plot_evaluate_regressor(y_pred: np.ndarray, y_true: np.ndarray,
                            labels: Sequence[str], title: str = "",
                            return_figure: bool = False):
  """Predicted-vs-true scatter grid with R²; returns {label: R²} (and the
  figure)."""
  d = _regressor_data(y_pred, y_true)
  y_true, y_pred = d["y_true"], d["y_pred"]
  plt = _pyplot()
  n = y_true.shape[1]
  ncol = min(4, n)
  nrow = int(np.ceil(n / ncol))
  fig, axes = plt.subplots(nrow, ncol, figsize=(3 * ncol, 3 * nrow),
                           squeeze=False)
  r2s = {}
  for i in range(n):
    ax = axes[i // ncol][i % ncol]
    yt, yp = y_true[:, i], y_pred[:, i]
    r2 = d["r2"][i]
    r2s[str(labels[i])] = float(r2)
    ax.scatter(yt, yp, s=4, alpha=0.4, linewidths=0)
    ax.set_title(f"{labels[i]} R2={r2:.2f}", fontsize=8)
  fig.suptitle(title)
  fig.tight_layout()
  if return_figure:
    return r2s, fig
  plt.close(fig)
  return r2s


def plot_evaluate_reconstruction(x: np.ndarray, x_rec: np.ndarray,
                                 title: str = "", n_cells: int = 8):
  """Original vs reconstructed count profiles for a few cells."""
  idx = np.linspace(0, x.shape[0] - 1, n_cells).astype(int)
  rows = torch.as_tensor(idx)
  x, x_rec = _host(_tensor(x)[rows]), _host(_tensor(x_rec)[rows])
  plt = _pyplot()
  fig, axes = plt.subplots(n_cells, 1, figsize=(10, 1.6 * n_cells),
                           squeeze=False)
  for r in range(len(idx)):
    ax = axes[r][0]
    ax.plot(x[r], lw=0.5, label="original")
    ax.plot(x_rec[r], lw=0.5, alpha=0.7, label="reconstructed")
    ax.set_yticks([])
    if r == 0:
      ax.legend(fontsize=6)
      ax.set_title(title, fontsize=9)
  fig.tight_layout()
  return fig
