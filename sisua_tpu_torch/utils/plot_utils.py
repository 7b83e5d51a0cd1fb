"""Series-statistics plots and the per-epoch monitoring figure (port of
``sisua_tpu/utils/plot_utils.py``): mean±std bands of sorted expression
series and the original / corrupted / imputed comparison panels.

Each function's data step (the sums, logs, sorts, the monitoring
figure's sample and latent PCA) runs in torch where its inputs lie; the
render step is the JAX code on matplotlib (``utils.visualization``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .visualization import _host, _pyplot, _tensor

__all__ = ["plot_series_statistics", "plot_monitoring_epoch",
           "plot_countsum_series", "plot_countsum_comparison"]


def _np_argsort(t: torch.Tensor) -> torch.Tensor:
  """``np.argsort`` of a vector (its sort kind, so its order of ties), as
  an index tensor on the vector's device."""
  return torch.as_tensor(np.argsort(_host(t)), device=t.device)


def _countsum_series_data(original, imputed, p=None,
                          reduce_axis: int = 0) -> dict:
  if isinstance(imputed, (tuple, list)):
    if len(imputed) != 3:
      raise ValueError("imputed must be (expected, stdev_total, "
                       "stdev_explained)")
    expected, stdev_total, stdev_explained = imputed
  else:
    imputed = _tensor(imputed)
    if imputed.ndim != 3 or imputed.shape[0] != 3:
      raise ValueError("imputed must be a stacked [3, n, g] array")
    expected, stdev_total, stdev_explained = imputed
  axis = int(reduce_axis)
  org = _tensor(original)

  def logsum(a):
    return torch.log1p(_tensor(a, org.device).sum(axis))
  obs = logsum(original)
  order = _np_argsort(obs)
  out = dict(obs=obs[order], exp=logsum(expected)[order],
             std_tot=logsum(stdev_total)[order],
             std_exp=logsum(stdev_explained)[order])
  if p is not None:
    out["p"] = _tensor(p, org.device).mean(axis)[order]
  return {k: _host(v) for k, v in out.items()}


def plot_countsum_series(original: np.ndarray,
                         imputed,
                         p: Optional[np.ndarray] = None,
                         reduce_axis: int = 0,
                         title: Optional[str] = None,
                         ax=None):
  """Log1p count-sums of observed vs expected with a ±stdev band, sorted by
  the observed series; optional dropout-probability overlay. ``imputed``
  is (expected, stdev_total, stdev_explained) as a tuple or a stacked
  [3, n, g] array."""
  from .visualization import to_axis
  d = _countsum_series_data(original, imputed, p, reduce_axis)
  ax = to_axis(ax, (10, 4))
  obs, exp, std_tot, std_exp = d["obs"], d["exp"], d["std_tot"], d["std_exp"]
  x = np.arange(len(obs))
  ax.plot(x, obs, lw=1.2, color="tab:blue", label="observed")
  ax.plot(x, exp, lw=1.0, color="tab:orange", label="expected")
  ax.fill_between(x, exp - std_tot, exp + std_tot,
                  alpha=0.15, color="tab:orange", label="total stdev")
  ax.fill_between(x, exp - std_exp, exp + std_exp,
                  alpha=0.3, color="tab:orange", label="explained stdev")
  ax.set_xlabel("rank by observed count-sum", fontsize=8)
  ax.set_ylabel("log1p count-sum", fontsize=8)
  ax.legend(fontsize=7)
  if p is not None:
    twin = ax.twinx()
    twin.plot(x, d["p"], lw=0.8, color="tab:red", alpha=0.6,
              label="dropout prob")
    twin.set_ylabel("dropout probability", fontsize=8, color="tab:red")
    twin.set_ylim(0, 1)
  if title:
    ax.set_title(title, fontsize=10)
  return ax


def _dist_or_array_mean(x) -> torch.Tensor:
  if hasattr(x, "mean") and not isinstance(x, (np.ndarray, torch.Tensor)):
    x = x.mean()
  x = _tensor(x)
  return x[0] if x.ndim == 3 else x


def _countsum_comparison_data(original, reconstructed, imputed,
                              comparing_axis: int = 0) -> dict:
  axis = int(comparing_axis)
  org = _tensor(original).sum(axis)
  rec = _dist_or_array_mean(reconstructed).to(org.device).sum(axis)
  imp = _dist_or_array_mean(imputed).to(org.device).sum(axis)
  if not org.shape == rec.shape == imp.shape:
    raise ValueError("original, reconstructed and imputed differ in shape")
  order = _np_argsort(org)
  org, rec, imp = (torch.log1p(v[order]) for v in (org, rec, imp))
  return dict(org=_host(org), rec=_host(rec), imp=_host(imp))


def plot_countsum_comparison(original: np.ndarray,
                             reconstructed,
                             imputed,
                             title: str = "",
                             comparing_axis: int = 0,
                             ax=None):
  """Scatter of reconstructed/imputed count-sums against the original, with
  per-series median lines."""
  from .visualization import to_axis
  d = _countsum_comparison_data(original, reconstructed, imputed,
                                comparing_axis)
  org, rec, imp = d["org"], d["rec"], d["imp"]
  plt = _pyplot()
  ax = to_axis(ax, (6, 6))
  colors = plt.get_cmap("Set2").colors
  ax.scatter(org, imp, c=[colors[1]], s=3, alpha=0.3, label="imputed")
  ax.scatter(org, rec, c=[colors[2]], s=3, alpha=0.3, label="reconstructed")
  for series, color, name in ((org, colors[0], "Original Median"),
                              (imp, colors[1], "Imputed Median"),
                              (rec, colors[2], "Reconstructed Median")):
    ax.axhline(y=float(np.median(series)), color=color, linestyle="--",
               linewidth=1.5, label=name)
  lim = float(max(org.max(), rec.max(), imp.max())) if org.size else 1.0
  ax.plot([0, lim], [0, lim], lw=0.8, ls=":", color="black")
  ax.set_xlabel("log1p original count-sum", fontsize=8)
  ax.set_ylabel("log1p predicted count-sum", fontsize=8)
  ax.legend(fontsize=7, markerscale=3)
  ax.set_title(title, fontsize=10)
  return ax


def _series_statistics_data(series: Dict[str, object],
                            log_scale: bool = True) -> dict:
  """Each series flattened and sorted (log1p'd when ``log_scale``)."""
  out = {}
  for name, values in series.items():
    v = torch.sort(_tensor(values).reshape(-1)).values
    if log_scale:
      v = torch.log1p(v)
    out[name] = _host(v)
  return dict(series=out, log_scale=log_scale)


def plot_series_statistics(series: Dict[str, np.ndarray],
                           log_scale: bool = True,
                           title: str = "",
                           ax=None):
  """Sorted-value curves with mean±std band per named series — the
  gene-series statistics figure."""
  d = _series_statistics_data(series, log_scale)
  return _render_series_statistics(d["series"], log_scale, title, ax)


def _render_series_statistics(series, log_scale, title, ax=None):
  if ax is None:
    plt = _pyplot()
    _, ax = plt.subplots(figsize=(8, 4))
  for name, v in series.items():
    ax.plot(v, lw=1, label=f"{name} (μ={v.mean():.2f}±{v.std():.2f})")
  ax.legend(fontsize=7)
  ax.set_xlabel("rank")
  ax.set_ylabel("log1p value" if log_scale else "value")
  ax.set_title(title, fontsize=10)
  return ax


def _monitoring_epoch_data(x_original, x_corrupted, x_imputed,
                           latents=None, labels=None, device=None) -> dict:
  """The monitoring figure's data: the column sums' sorted series, a
  seeded sample of 50,000 (original, imputed) entries in log1p, and the
  latents' 2-D PCA (the port's PCA, where the latents lie)."""
  org = _tensor(x_original, device)
  imp = _tensor(x_imputed, org.device)
  series = {"original": org.sum(0), "imputed": imp.sum(0)}
  if x_corrupted is not None:
    series["corrupted"] = _tensor(x_corrupted, org.device).sum(0)
  out = _series_statistics_data(series)
  idx = np.random.default_rng(0).choice(
      org.numel(), min(50_000, org.numel()), replace=False)
  idx = torch.as_tensor(idx, device=org.device)
  out["hex_x"] = _host(torch.log1p(org.reshape(-1)[idx]))
  out["hex_y"] = _host(torch.log1p(imp.reshape(-1)[idx]))
  out["emb"], out["labels"] = None, None
  if latents is not None:
    z = _tensor(latents, org.device)
    if z.shape[1] == 1:      # 1-D latent: pad a zero y-axis
      emb = torch.cat([z, torch.zeros_like(z)], 1)
    elif z.shape[1] == 2:
      emb = z
    else:
      from ..analysis.decomposition import PCA
      emb = PCA(2, device=z.device).fit_transform(z)
    out["emb"] = _host(emb)
    out["labels"] = None if labels is None else np.asarray(labels)
  return out


def plot_monitoring_epoch(x_original: np.ndarray,
                          x_corrupted: Optional[np.ndarray],
                          x_imputed: np.ndarray,
                          latents: Optional[np.ndarray] = None,
                          labels: Optional[Sequence] = None,
                          epoch: int = 0,
                          title: str = ""):
  """One monitoring figure per eval epoch: count-series comparison +
  imputation scatter + (optional) latent scatter."""
  d = _monitoring_epoch_data(x_original, x_corrupted, x_imputed, latents,
                             labels)
  return _render_monitoring_epoch(epoch=epoch, title=title, **d)


def _render_monitoring_epoch(series, log_scale, hex_x, hex_y, emb, labels,
                             epoch, title):
  from .visualization import fast_scatter
  plt = _pyplot()
  ncols = 3 if emb is not None else 2
  fig, axes = plt.subplots(1, ncols, figsize=(5 * ncols, 4))
  _render_series_statistics(series, log_scale, f"{title} epoch {epoch}",
                            axes[0])
  axes[1].hexbin(hex_x, hex_y, gridsize=50, bins="log")
  axes[1].set_xlabel("log1p original")
  axes[1].set_ylabel("log1p imputed")
  if emb is not None:
    fast_scatter(emb, labels=labels, title="latent", ax=axes[2])
  fig.tight_layout()
  return fig
