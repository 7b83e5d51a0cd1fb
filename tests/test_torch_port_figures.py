"""The port's plotting layer against the JAX package's: ``utils``'
``visualization`` and ``plot_utils``, the 15 figure methods of
``SingleCellOMIC`` and the ``imputation`` and ``latent`` plots.

Both packages' containers come from ``generate_synthetic`` with one seed
(the port's generator is bitwise the JAX one); each figure is reduced to
what it draws (``torch_port_figure_helper``) and held to the JAX figure:
strings, counts and fixed colours exactly; numbers within 1e-10 where both
sides compute in float64 and 1e-5 relative (atol 1e-6) where the JAX
figure computes in float32 (log1p, group means, scaled values); the PCA
scatters within 2e-4 of a column's range (float32 PCA, signs by
``svd_flip``: ROADMAP A23); the t-SNE scatters by trustworthiness within
0.02 of the JAX embedding's, each cell's colour and label exact. Beside
each render sits a check that without matplotlib it raises an
``ImportError`` naming it, and ``figure_data()`` gives the same names
without drawing.
"""

import os
import sys

import numpy as np
import pytest
import torch

from torch_port_figure_helper import (assert_figures_equal, reduce_figure)

import sisua_tpu.data as JD
import sisua_tpu_torch.data as TD
from torch_port_threads import _one_thread_tsne  # noqa: F401

F32 = dict(rtol=1e-5, atol=1e-6)


def _pair(**kw):
  return JD.generate_synthetic(**kw), TD.generate_synthetic(**kw)


@pytest.fixture(scope="module")
def scos():
  return _pair(n_cells=150, n_genes=60, n_proteins=6, n_celltypes=3,
               seed=5)


def _same(jfigs, tfigs, **tol):
  assert list(tfigs) == list(jfigs)
  for k in jfigs:
    assert_figures_equal(reduce_figure(tfigs[k]), reduce_figure(jfigs[k]),
                         name=k, **tol)


CASES = [
    ("plot_scatter", dict(color_by="celltype", algo="pca"), "pca"),
    ("plot_stacked_violins", dict(group_by="proteomic"), None),
    ("plot_stacked_violins", dict(group_by="celltype", swap_axes=True,
                                  rank_vars=2, dendrogram=True), None),
    ("plot_dotplot", dict(group_by="celltype", dendrogram=True,
                          rank_genes=3), None),
    ("plot_dotplot", dict(group_by="proteomic", var_names=10,
                          standard_scale=None), None),
    ("plot_heatmap", dict(group_by="proteomic", dendrogram=True), None),
    ("plot_heatmap", dict(group_by="celltype", groups=2, swap_axes=True,
                          standard_scale="obs", dendrogram=True), None),
    ("plot_heatmap", dict(group_by="proteomic", clustering="kmeans",
                          rank_genes=3), None),
    ("plot_heatmap", dict(X="proteomic", group_by="celltype",
                          var_names=None), None),
    ("plot_dendrogram_heatmap", dict(group_by="celltype"), None),
    ("plot_distance_heatmap", dict(group_by="celltype"), None),
    ("plot_mutual_information", dict(), "f64"),
    ("plot_pearson_matrix", dict(), None),
    ("plot_spearman_matrix", dict(), "f64"),
    ("plot_correlation_scatter", dict(), None),
    ("plot_divergence", dict(algo="pca"), "pca"),
    ("plot_histogram", dict(), None),
    ("plot_percentile_histogram", dict(), None),
    ("plot_series", dict(), None),
]


@pytest.mark.parametrize("method,kw,tol", CASES,
                         ids=[f"{m}-{i}" for i, (m, _, _) in enumerate(CASES)])
def test_visualizer_figure_matches_jax(scos, method, kw, tol):
  j, t = scos
  kw = dict(kw)
  if kw.get("groups") == 2:
    kw["groups"] = list(np.unique(j._process_omics("celltype")[1])[:2])
  j.figures.clear()
  t.figures.clear()
  getattr(j, method)(**kw)
  getattr(t, method)(**kw, device="cpu")
  if tol == "pca":
    _same(j.figures, t.figures, column_atol=2e-4, **F32)
  elif tol == "f64":
    _same(j.figures, t.figures, rtol=1e-10, atol=1e-10)
  else:
    _same(j.figures, t.figures, **F32)
  # the data step alone: the same names, and nothing drawn
  names = list(t.figures)
  t.figures.clear()
  with t.figure_data() as data:
    getattr(t, method)(**kw, device="cpu")
  assert list(data) == names and not t.figures


def test_importance_matrix_matches_jax():
  """The forests' importances (trees on the host): a narrow container."""
  j, t = _pair(n_cells=80, n_genes=12, n_proteins=2, n_celltypes=2, seed=9)
  j.plot_importance_matrix()
  t.plot_importance_matrix(device="cpu")
  _same(j.figures, t.figures, rtol=1e-10, atol=1e-10)


def test_tsne_scatter_matches_jax_by_trustworthiness(scos):
  from sisua_tpu_torch.analysis.manifold import trustworthiness
  j, t = scos
  j.figures.clear()
  t.figures.clear()
  j.plot_scatter(X="proteomic", color_by="celltype", algo="tsne")
  t.plot_scatter(X="proteomic", color_by="celltype", algo="tsne",
                 device="cpu")
  _same(j.figures, t.figures, offsets=False, **F32)
  x = j.numpy("proteomic")  # the embedding's input: its PCA, all columns
  jt = trustworthiness(x, j.obsm["proteomic_tsne"], device="cpu")
  tt = trustworthiness(x, t.obsm["proteomic_tsne"], device="cpu")
  assert abs(jt - tt) <= 0.02
  np.testing.assert_array_equal(j._process_omics("celltype")[1],
                                t._process_omics("celltype", device="cpu")[1])


def test_container_figures_save_as_jax(scos, tmp_path):
  """``save_figures``: the same PNG names, or one PDF; a replaced name
  keeps its place."""
  j, t = scos
  for s, kw in ((j, {}), (t, dict(device="cpu"))):
    s.figures.clear()
    s.plot_series(**kw).plot_histogram(**kw).plot_series(**kw)
    s.save_figures(str(tmp_path / type(s).__module__), clear_figures=False)
    s.save_figures(str(tmp_path / f"{type(s).__module__}.pdf"),
                   separate_files=False)
    assert not s.figures
  assert sorted(os.listdir(tmp_path / "sisua_tpu.data.dataset")) == sorted(
      os.listdir(tmp_path / "sisua_tpu_torch.data.dataset")) == [
          "transcriptomic_histogram.png", "transcriptomic_series.png"]
  assert (tmp_path / "sisua_tpu_torch.data.dataset.pdf").stat().st_size > 0


def test_renders_name_matplotlib_when_it_is_missing(scos, monkeypatch):
  from sisua_tpu_torch.analysis.imputation import plot_imputation
  from sisua_tpu_torch.utils import fast_scatter
  _, t = scos
  monkeypatch.setitem(sys.modules, "matplotlib", None)
  for call in (lambda: t.plot_series(device="cpu"),
               lambda: fast_scatter(np.zeros((3, 2))),
               lambda: plot_imputation(np.ones((3, 2)), np.ones((3, 2)))):
    with pytest.raises(ImportError, match="matplotlib"):
      call()
  with t.figure_data() as data:  # the data steps need no matplotlib
    t.plot_series(device="cpu").plot_dotplot(device="cpu")
  assert len(data) == 2


# ------------------------------------------------------------ utils' plots
def _utils():
  import sisua_tpu.utils as JU
  import sisua_tpu_torch.utils as TU
  return JU, TU


def test_downsample_data_gives_the_jax_rows_bitwise():
  JU, TU = _utils()
  x = np.arange(9000 * 2).reshape(9000, 2)
  y = np.arange(9000)
  for a, b in zip(JU.downsample_data(x, None, y, max_samples=500),
                  TU.downsample_data(x, None, y, max_samples=500)):
    np.testing.assert_array_equal(a, b) if a is not None else None
    assert (a is None) == (b is None)
  t = TU.downsample_data(torch.as_tensor(x), max_samples=500)[0]
  np.testing.assert_array_equal(t.numpy(), JU.downsample_data(
      x, max_samples=500)[0])
  small = x[:10]
  assert TU.downsample_data(small, max_samples=500)[0] is small


def test_utils_plots_match_jax():
  JU, TU = _utils()
  rng = np.random.default_rng(0)
  org = rng.poisson(3, (120, 30)).astype(np.float32)
  imp = (org + rng.gamma(1.0, 0.5, org.shape)).astype(np.float32)
  cor = org * (rng.random(org.shape) > 0.2)
  std = rng.gamma(1.0, 0.3, org.shape).astype(np.float32)
  lat = rng.normal(size=(120, 5)).astype(np.float32)
  labels = np.asarray(["a", "b", "c"])[rng.integers(0, 3, 120)]
  p = rng.random(org.shape).astype(np.float32)
  y_true = rng.random((120, 4))
  y_pred = y_true + rng.normal(0, 0.3, y_true.shape)
  names = ["p0", "p1", "p2", "p3"]

  def fig(ax):
    return ax.get_figure()
  pairs = [
      (fig(JU.fast_scatter(lat, labels=labels, title="t")),
       fig(TU.fast_scatter(lat, labels=labels, title="t")), {}),
      (fig(JU.show_image(org, True)), fig(TU.show_image(org, True)), {}),
      (fig(JU.show_image(org[0])), fig(TU.show_image(org[0])), {}),
      (JU.plot_evaluate_classifier(y_pred, y_true, names, "c", True)[1],
       TU.plot_evaluate_classifier(y_pred, y_true, names, "c", True,
                                   device="cpu")[1], {}),
      (JU.plot_evaluate_regressor(y_pred, y_true, names, "r", True)[1],
       TU.plot_evaluate_regressor(y_pred, y_true, names, "r", True)[1], {}),
      (JU.plot_evaluate_reconstruction(org, imp, "x"),
       TU.plot_evaluate_reconstruction(org, imp, "x"), {}),
      (fig(JU.plot_countsum_series(org, (imp, std, std / 2), p=p, title="s")),
       fig(TU.plot_countsum_series(org, (imp, std, std / 2), p=p,
                                   title="s")), F32),
      (fig(JU.plot_countsum_series(org, np.stack([imp, std, std]),
                                   reduce_axis=1)),
       fig(TU.plot_countsum_series(org, np.stack([imp, std, std]),
                                   reduce_axis=1)), F32),
      (fig(JU.plot_countsum_comparison(org, imp[None], imp, "c")),
       fig(TU.plot_countsum_comparison(org, imp[None], imp, "c")), F32),
      (fig(JU.plot_series_statistics({"a": org.sum(0), "b": imp.sum(0)},
                                     title="x")),
       fig(TU.plot_series_statistics({"a": org.sum(0), "b": imp.sum(0)},
                                     title="x")), F32),
      (JU.plot_monitoring_epoch(org, cor, imp, lat, labels, 3, "m"),
       TU.plot_monitoring_epoch(org, cor, imp, lat, labels, 3, "m"),
       dict(column_atol=2e-4, **F32)),
  ]
  for i, (j, t, tol) in enumerate(pairs):
    tol = tol or dict(rtol=1e-10, atol=1e-10)
    assert_figures_equal(reduce_figure(t), reduce_figure(j), name=str(i),
                         **tol)
  v = TU.Visualizer()
  v.add_figure("a", pairs[0][1]).add_figure("a", pairs[1][1])
  assert list(v.figures) == ["a"] and v.figures["a"] is pairs[1][1]


# ------------------------------------------------- imputation and latent
def test_imputation_and_latent_plots_match_jax():
  import sisua_tpu.analysis.imputation as JI
  import sisua_tpu.analysis.latent as JL
  import sisua_tpu_torch.analysis.imputation as TI
  import sisua_tpu_torch.analysis.latent as TL
  from sisua_tpu_torch.analysis.manifold import trustworthiness
  j, _ = _pair(n_cells=150, n_genes=20, n_proteins=10, n_celltypes=3,
               seed=4)
  rng = np.random.default_rng(1)
  org = j.numpy("transcriptomic")
  imp = (org + rng.gamma(1.0, 0.5, org.shape)).astype(np.float32)
  y = j.numpy("proteomic")
  names = list(j.get_var_names("proteomic"))
  ids = j.numpy("celltype").argmax(1)
  z = (rng.normal(size=(150, 6)) + 3 * np.eye(3, 6)[ids]).astype(np.float32)
  lab = np.asarray(["x", "y", "z"])[ids]
  ybin = (y > np.median(y, 0)).astype(np.float32)
  figs = [
      (JI.plot_imputation(org, imp, title="i"),
       TI.plot_imputation(org, imp, title="i"), F32),
      (JI.plot_imputation_series(org.sum(0), imp.sum(0), "s"),
       TI.plot_imputation_series(org.sum(0), imp.sum(0), "s"),
       dict(rtol=1e-10, atol=1e-10)),
      (JL.plot_distance_heatmap(z, lab, "d"),
       TL.plot_distance_heatmap(z, lab, "d", device="cpu"), F32),
      (JL.plot_latents_protein_pairs(z, y, names, algo="pca", title="p"),
       TL.plot_latents_protein_pairs(z, y, names, algo="pca", title="p",
                                     device="cpu"),
       dict(column_atol=2e-4, **F32)),
      (JL.plot_latents_binary(z, ybin, names, algo="pca", title="b"),
       TL.plot_latents_binary(z, ybin, names, algo="pca", title="b",
                              device="cpu"),
       dict(column_atol=2e-4, **F32)),
      (JL.plot_latents_binary(z, ybin, names, title="b"),
       TL.plot_latents_binary(z, ybin, names, title="b", device="cpu"),
       dict(offsets=False, **F32)),
  ]
  for i, (jf, tf, tol) in enumerate(figs):
    assert_figures_equal(reduce_figure(tf), reduce_figure(jf), name=str(i),
                         **tol)
  # the t-SNE scatter: its embedding's trustworthiness
  je, te = JL._embed2d(z, "tsne"), TL._embed2d(z, "tsne", device="cpu")
  assert abs(trustworthiness(z, je, device="cpu")
             - trustworthiness(z, te, device="cpu")) <= 0.02
  assert JL.plot_latents_protein_pairs(z, y, ["q"] * 10) is None
  assert TL.plot_latents_protein_pairs(z, y, ["q"] * 10,
                                       device="cpu") is None


def test_streamline_classifier_returns_the_jax_figure():
  import sisua_tpu.analysis.latent as JL
  import sisua_tpu_torch.analysis.latent as TL
  rng = np.random.default_rng(2)
  y = (rng.random((200, 4)) > 0.5).astype(np.float32)
  z = (y @ rng.normal(size=(4, 5)) + 0.3 * rng.normal(size=(200, 5)))
  z = z.astype(np.float32)
  names = ["a", "b", "c", "d"]
  (jtr, jte), jf = JL.streamline_classifier(z[:150], y[:150], z[150:],
                                           y[150:], names,
                                           return_figure=True, title="f")
  (ttr, tte), tf = TL.streamline_classifier(z[:150], y[:150], z[150:],
                                           y[150:], names,
                                           return_figure=True, title="f",
                                           device="cpu")
  assert list(tte) == list(jte)
  for k in jte:
    assert abs(tte[k] - jte[k]) <= 0.01, k
  gj, gt = reduce_figure(jf)["axes"][0], reduce_figure(tf)["axes"][0]
  assert gt["xticklabels"] == gj["xticklabels"] == names
  assert gt["title"].startswith("f (mean F1=")
  # the bars are the test F1s, held as the F1s are (liblinear's tolerance)
  np.testing.assert_allclose([p[2] for p in gt["patches"]],
                             [p[2] for p in gj["patches"]], atol=0.01)
  assert TL.streamline_classifier(z, np.zeros_like(y), z, y, names,
                                  return_figure=True,
                                  device="cpu") == (({}, {}), None)
