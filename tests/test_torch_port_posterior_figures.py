"""The figure batteries of the port's ``Posterior`` and ``ResultsSheet``,
``sisua_tpu_torch.cli.evaluate`` with its figures and ``cross_analyze``,
against the JAX package's.

The hubs are built the way ``test_torch_port_posterior.py`` builds them: a
SISUA (RNA + proteins, a cell-type factor) in each package on the same
``generate_synthetic`` data, both models' ``predict`` returning
distributions of the same arrays (the corrupted source first, then the
original), the same ``seed`` and ``sample_shape``, and the same loaded
history. ``plot_all(full=True)`` gives the same ordered figure names; each
figure, run by its own group of methods, matches the JAX figure through
``torch_port_figure_helper``: strings, counts and fixed colours exactly,
numbers within 1e-5 relative (atol 1e-6: the hub's float32 model outputs
and the JAX figures' float32 steps; atol 1e-5 for the min-max scaled dot
plots and heatmaps); the PCA scatters within 2e-4 of a
column's range; the t-SNE and UMAP scatters by trustworthiness within
0.02 of the JAX embeddings', each cell's colour and label exact; the
disentanglement suite's betaVAE and FactorVAE bars (classifier
accuracies: the port's solver at its optimum, liblinear's at its
tolerance) within 0.01. The CLIs write the same figure files as the JAX
CLIs on the same config and data.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sisua_tpu.dist as JD
import sisua_tpu.models as J
from sisua_tpu.data import generate_synthetic
from sisua_tpu.rv import RVmeta as JRV
import sisua_tpu_torch.dist as TD
from sisua_tpu_torch import models as T
from sisua_tpu_torch.data.adapters import sco_posterior
from sisua_tpu_torch.data.dataset import SingleCellOMIC
from sisua_tpu_torch.rv import RVmeta as TRV
from torch_port_figure_helper import assert_figures_equal, reduce_figure
from torch_port_threads import _one_thread_tsne  # noqa: F401

S, N, G, P, L = 3, 100, 40, 6, 3
F32 = dict(rtol=1e-5, atol=1e-6)
HISTORY = {"loss": [5.0, 4.0, 3.5], "val_loss": [5.5, 4.5, 4.25]}


@pytest.fixture(scope="module")
def sco():
  return generate_synthetic(n_cells=N, n_genes=G, n_proteins=P,
                            n_celltypes=3, seed=3)


def _fields(seed, n, cols, kind):
  rng = np.random.default_rng(seed)
  f = lambda *shape: rng.normal(0, 1, shape).astype(np.float32)  # noqa
  out = dict(total_count=np.exp(f(S, n, cols)).astype(np.float32),
             logits=f(S, n, cols))
  if kind == "zinb":
    out["gate"] = f(S, n, cols)
  return out


def _dist(pkg, p):
  a = jnp.asarray if pkg is JD else torch.tensor
  count = pkg.NegativeBinomial(a(p["total_count"]), a(p["logits"]))
  if "gate" in p:
    count = pkg.ZeroInflated(count, a(p["gate"]))
  return pkg.Independent(count, 1)


def _predictions(kinds, sco, seed):
  """(JAX (pX, qZ), port (pX, qZ)) of one source: latent means that
  follow the cell types."""
  n = sco.n_obs
  params = [_fields(seed + i, n, d, k) for i, (d, k) in enumerate(kinds)]
  rng = np.random.default_rng(seed + 10)
  ids = sco.numpy("celltype").argmax(1)
  loc = (rng.normal(size=(n, L)) + 3.0 * np.eye(3, L)[ids]).astype(
      np.float32)

  def one(pkg):
    a = jnp.asarray if pkg is JD else torch.tensor
    px = tuple(_dist(pkg, p) for p in params)
    qz = pkg.MultivariateNormalDiag(loc=a(loc),
                                    scale_diag=a(np.ones_like(loc)))
    return (px if len(px) > 1 else px[0]), qz
  return one(JD), one(TD)


MODELS = {"sisua": (J.SISUA, T.SISUA, [(G, "zinb"), (P, "nb")]),
          "vae": (J.VAE, T.VAE, [(G, "zinb")])}


def _port_sco(sco):
  """The port's container of the JAX container's matrices and names."""
  omics = list(sco.omics)
  t = SingleCellOMIC(sco.numpy(omics[0]), gene_id=sco.get_var_names(
      omics[0]), omic=omics[0], name=sco.name)
  for o in omics[1:]:
    t.add_omic(o, sco.numpy(o), sco.get_var_names(o))
  return t


def _hubs(sco, name="sisua"):
  """(JAX hub, port hub) of one model class at the same predictions."""
  jcls, tcls, kinds = MODELS[name]
  names = ["transcriptomic", "proteomic"]
  jm = jcls([JRV(d, k, name=n) for (d, k), n in zip(kinds, names)])
  tm = tcls([TRV(d, k, name=n) for (d, k), n in zip(kinds, names)],
            device="cpu")
  jm._loaded_history = tm._loaded_history = dict(HISTORY)
  cor, org = _predictions(kinds, sco, 0), _predictions(kinds, sco, 100)
  calls = {"jax": 0, "port": 0}

  def fake(pkg, i):
    def predict(*a, **kw):
      calls[pkg] += 1
      return (cor if calls[pkg] == 1 else org)[i]
    return predict
  jm.predict, tm.predict = fake("jax", 0), fake("port", 1)
  jpost = jm.create_posterior(sco, sample_shape=S)
  tpost = sco_posterior(tm, _port_sco(sco), sample_shape=S)
  assert tpost.name == jpost.name
  return jpost, tpost


def _tol(name):
  if any(k in name for k in ("_tsne", "_umap", "protein_pairs",
                             "latent_binary")):
    return dict(offsets=False, **F32)
  if any(k in name for k in ("_dotplot_", "_heatmap_")):
    # min-max scaled float32 log1p means: torch's and numpy's float32
    # log1p differ by an ulp, which the scaling divides by the range
    return dict(rtol=1e-5, atol=1e-5)
  if any(k in name for k in ("_pca", "divergence", "scatter_")):
    return dict(column_atol=2e-4, **F32)
  return F32


def _loose_suite_bars(red):
  """The betaVAE/FactorVAE bars of a disentanglement figure, taken out
  of its reduction (they are held within 0.01)."""
  ax = next(a for a in red["axes"] if a["title"] == "disentanglement suite")
  names = ax["xticklabels"]
  keep, out = [], []
  for lab, patch in zip(names, ax["patches"]):
    (out if lab.startswith(("betavae", "factorvae")) else keep).append(patch)
  ax["patches"] = keep
  return [p[2] for p in out]


def _same(jfigs, tfigs):
  assert list(tfigs) == list(jfigs)
  for k in jfigs:
    gj, gt = reduce_figure(jfigs[k]), reduce_figure(tfigs[k])
    if "_disentanglement_" in k and "scatter" not in k:
      np.testing.assert_allclose(_loose_suite_bars(gt),
                                 _loose_suite_bars(gj), atol=0.01)
    if k.startswith("barplot_"):
      # seaborn's bootstrapped error bars draw from an unseeded generator,
      # in the JAX render too: the bars are compared, not the error lines
      for red in (gj, gt):
        red["axes"][0]["lines"] = []
    assert_figures_equal(gt, gj, name=k, **_tol(k))


# the ordered figure names of ``plot_all(full=True)`` on the hubs, less
# the hub's name and '_' (the JAX hub's; both tests below hold them)
FULL_NAMES = [
    'learning_curves',
    'imputation',
    'latent_proteomic_pca',
    'distance_proteomic',
    'spearman_proteomic',
    'protein_pairs',
    'latent_binary',
    'confusion_celltype',
    'disentanglement_proteomic',
    'disentanglement_celltype',
    'series',
    'llk',
    'protein_prediction',
    'latent_proteomic_divergence',
    'latent_proteomic_tsne',
    'latent_iproteomic_tsne',
    'latent_proteomic_umap',
    'latent_iproteomic_umap',
    'series_proteomic',
    'violin_transcriptomic_proteomic_v6_log',
    'heatmap_transcriptomic_proteomic_v6_log_scale-var',
    'violin_transcriptomic_iproteomic_v6_log',
    'heatmap_transcriptomic_iproteomic_v6_log_scale-var',
    'violin_itranscriptomic_proteomic_v6_log',
    'heatmap_itranscriptomic_proteomic_v6_log_scale-var',
    'violin_itranscriptomic_iproteomic_v6_log',
    'heatmap_itranscriptomic_iproteomic_v6_log_scale-var',
    'dendrogram_itranscriptomic_proteomic',
    'dotplot_itranscriptomic_proteomic_v6_log_scale-var',
    'confusion_proteomic',
    'pearson_proteomic',
    'mi_proteomic',
    'importance_proteomic',
    'disentanglement_iproteomic',
    'spearman_transcriptomic_proteomic',
    'pearson_transcriptomic_proteomic',
    'spearman_itranscriptomic_proteomic',
    'pearson_itranscriptomic_proteomic',
    'disentanglement_scatter_proteomic',
    'disentanglement_scatter_iproteomic',
    'transcriptomic_proteomic_corr_scatter',
    'itranscriptomic_proteomic_corr_scatter',
    'latent_celltype_tsne',
    'latent_celltype_umap',
    'violin_transcriptomic_celltype_v6_log',
    'heatmap_transcriptomic_celltype_v6_log_scale-var',
    'violin_itranscriptomic_celltype_v6_log',
    'heatmap_itranscriptomic_celltype_v6_log_scale-var',
    'dendrogram_itranscriptomic_celltype',
    'dotplot_itranscriptomic_celltype_v6_log_scale-var',
    'distance_celltype',
    'spearman_celltype',
    'pearson_celltype',
    'mi_celltype',
    'importance_celltype',
    'distheatmap_transcriptomic_celltype',
    'distheatmap_itranscriptomic_celltype'
]


def test_jax_plot_all_full_names(sco):
  """The JAX hub's rendered battery gives FULL_NAMES, in order."""
  jpost, _ = _hubs(sco)
  jpost.plot_all(full=True)
  assert list(jpost.figures) == [f"{jpost.name}_{k}" for k in FULL_NAMES]


def test_plot_all_full_gives_the_jax_names(sco):
  """The port's data steps alone (no figure drawn) give the JAX hub's
  ordered names, FULL_NAMES."""
  _, tpost = _hubs(sco)
  with tpost.figure_data() as data:
    tpost.plot_all(full=True)
  assert list(data) == [f"{tpost.name}_{k}" for k in FULL_NAMES]
  assert not tpost.figures


# the summary's figures that no group below draws (its others are drawn
# there; its names lead FULL_NAMES)
GROUPS = {
    "summary": [("plot_learning_curves", {}),
                ("plot_imputation_scatter", {}),
                ("plot_scatter", dict(algo="pca")),
                ("plot_latents_protein_pairs", {}),
                ("plot_latents_binary", {}), ("plot_series", {})],
    "llk_protein_series": [("plot_llk_bars", {}),
                           ("plot_protein_prediction", {}),
                           ("plot_divergence", {}),
                           ("plot_series", dict(omic="proteomic"))],
    "embeddings": [("plot_scatter", dict(color_by=f, algo=a))
                   for f in ("proteomic", "iproteomic", "celltype")
                   for a in ("tsne", "umap")],
    "violins_heatmaps": [(m, dict(omic=o, group_by=g))
                         for o in ("transcriptomic", "itranscriptomic")
                         for g in ("proteomic", "iproteomic", "celltype")
                         for m in ("plot_violins", "plot_heatmap")],
    "dendrogram_dotplot_distances": [
        (m, dict(group_by=f)) for f in ("proteomic", "celltype")
        for m in ("plot_dendrogram", "plot_dotplot")] + [
        ("plot_distance_heatmap", dict(factor_omic=f))
        for f in ("proteomic", "celltype")] + [
        ("plot_distance_heatmap", dict(factor_omic="celltype", omic=o))
        for o in ("transcriptomic", "itranscriptomic")],
    "latent_matrices": [("plot_confusion_matrix", dict(factor_omic=f))
                        for f in ("proteomic", "celltype")] + [
        ("plot_correlation_matrix", dict(method=m, factor_omic=f))
        for f in ("proteomic", "celltype") for m in ("spearman", "pearson")],
    # with the MI and importance matrices, which share the criticizers
    "disentanglement": [("plot_disentanglement", dict(factor_omic=f))
                        for f in ("proteomic", "iproteomic", "celltype")] + [
        ("plot_correlation_matrix", dict(method=m, factor_omic=f))
        for f in ("proteomic", "celltype") for m in ("mi", "importance")],
    "marker_matrices_scatters": [
        ("plot_correlation_matrix", dict(method=m, factor_omic="proteomic",
                                         omic1=o))
        for o in ("transcriptomic", "itranscriptomic")
        for m in ("spearman", "pearson")] + [
        ("plot_disentanglement_scatter", dict(factor_omic=f))
        for f in ("proteomic", "iproteomic")] + [
        ("plot_correlation_scatter", dict(imputed=i)) for i in (False, True)],
}


@pytest.mark.parametrize("group", list(GROUPS))
def test_posterior_figures_match_jax(sco, group, tmp_path):
  """Each figure of the battery, group by group, and ``save_figures``'s
  file names."""
  from sisua_tpu_torch.analysis.manifold import trustworthiness
  jpost, tpost = _hubs(sco)
  for method, kw in GROUPS[group]:
    getattr(jpost, method)(**kw)
    getattr(tpost, method)(**kw)
  _same(jpost.figures, tpost.figures)
  if group == "embeddings":
    z = jpost.latents
    for algo in ("tsne", "umap"):
      jt = trustworthiness(z, jpost.sco_analysis.obsm[f"latent_{algo}"],
                           device="cpu")
      tt = trustworthiness(z, tpost.sco_analysis.obsm[f"latent_{algo}"],
                           device="cpu")
      assert abs(jt - tt) <= 0.02, algo
  jpost.save_figures(str(tmp_path / "j"))
  tpost.save_figures(str(tmp_path / "t"))
  assert sorted(os.listdir(tmp_path / "t")) == sorted(
      os.listdir(tmp_path / "j"))
  assert not tpost.figures


SHEET_CALLS = {
    "plot_all": [("plot_all", ())],
    "the_rest": [("boxplot_pearson", ()), ("boxplot_cluster", ()),
                 ("barplot_f1", ()), ("barplot_spearman", ()),
                 ("barplot_pearson", ()), ("plot_scores", ("imputation",)),
                 ("plot_latents_binary_scatter", ()),
                 ("plot_imputation_scatter", ()),
                 ("plot_latents_scatter", ())],
}


@pytest.mark.parametrize("calls", list(SHEET_CALLS))
def test_results_sheet_figures_match_jax(sco, calls, tmp_path):
  """``ResultsSheet.plot_all``, and the rest of its figure methods, over
  a SISUA and a VAE hub; the score table is each hub's ``save_scores``
  replaced by one shared dict (its parity is
  ``test_torch_port_posterior.py``'s)."""
  from sisua_tpu.analysis import ResultsSheet as JR
  from sisua_tpu_torch.analysis import ResultsSheet as TR
  hubs = [_hubs(sco, "sisua"), _hubs(sco, "vae")]
  rng = np.random.default_rng(5)
  keys = ["llk_a", "imputation_med", "imputation_mean", "spearman_mean",
          "pearson_mean", "f1_CD4", "f1_CD8", "mig_proteomic",
          "dci_proteomic", "ARI_celltype", "beta_x"]
  for i, pair in enumerate(hubs):
    table = {k: float(v) for k, v in zip(keys, rng.random(len(keys)))}
    if i:
      table["protein_pearson_mean"] = 0.5
      table["imputation_std"] = float("nan")
    for p in pair:
      p.save_scores = (lambda t=table: dict(t))
  js, ts = JR(*[h[0] for h in hubs]), TR(*[h[1] for h in hubs])
  for sheet in (js, ts):
    for method, args in SHEET_CALLS[calls]:
      getattr(sheet, method)(*args)
  _same(js.figures, ts.figures)
  names = list(ts.figures)
  js.save_plots(str(tmp_path / "j"))
  ts.save_plots(str(tmp_path / "t"))
  assert sorted(os.listdir(tmp_path / "t")) == sorted(
      os.listdir(tmp_path / "j"))
  with ts.figure_data() as data:
    for method, args in SHEET_CALLS[calls]:
      getattr(ts, method)(*args)
  assert list(data) == names and not ts.figures


def test_plot_all_without_matplotlib_names_it(sco, monkeypatch):
  import sys
  _, tpost = _hubs(sco)
  monkeypatch.setitem(sys.modules, "matplotlib", None)
  for full in (False, True):
    with pytest.raises(ImportError, match="matplotlib"):
      tpost.plot_all(full=full)
  with tpost.figure_data() as data:
    tpost.plot_learning_curves().plot_llk_bars()
  assert list(data) == [f"{tpost.name}_learning_curves", f"{tpost.name}_llk"]


# ----------------------------------------------------------- the two CLIs
@pytest.fixture(scope="module")
def stores(tmp_path_factory):
  """A VAE trained one epoch on synthetic200 by the JAX package, saved,
  and loaded by both packages; each experimenter's ``get_models`` gives
  it with its config."""
  import sisua_tpu.data as JDD
  from sisua_tpu.nn import NetConf
  root = tmp_path_factory.mktemp("stores")
  train, _ = JDD.get_dataset("synthetic200").split(0.8)
  # a 2-dim latent: the DCI's boosted trees grow over every latent dim
  jm = J.VAE(JRV(train.n_vars, "zinb", name="transcriptomic"),
             latents=JRV(2, "diag", True, "latents"),
             encoder=NetConf((16,)), decoder=NetConf((16,)))
  jm.fit(train, epochs=1, batch_size=32)
  jm.save_weights(str(root / "model"))
  cfg = {"model": {"name": "vae"},
         "dataset": {"name": "synthetic200", "train_percent": 0.8}}
  return dict(root=root, cfg=cfg, jax=J.load_model(str(root / "model")),
              port=T.load_model(str(root / "model"), device="cpu"))


def _patch_experimenters(monkeypatch, stores):
  """Both experimenters in the store's folders, their ``get_models`` the
  loaded VAE; ``Figure.savefig`` touches its file (the CLIs' file names
  are what is compared here, the figures above)."""
  from matplotlib.figure import Figure
  import sisua_tpu.train.experimenter as JX
  monkeypatch.setattr(Figure, "savefig",
                      lambda self, fp, *a, **k: open(fp, "wb").close())
  import sisua_tpu_torch.train.experimenter as TX
  for mod, key in ((JX, "jax"), (TX, "port")):
    cls = mod.SisuaExperimenter
    init = cls.__init__

    def new_init(self, *a, init=init, key=key, **k):
      k["save_path"] = str(stores["root"] / f"exp_{key}")
      init(self, *a, **k)
    monkeypatch.setattr(cls, "__init__", new_init)
    monkeypatch.setattr(cls, "get_models",
                        lambda self, *a, key=key, **k:
                        [(stores["cfg"], stores[key])])


def test_evaluate_cli_writes_the_jax_figures(stores, tmp_path, monkeypatch):
  from sisua_tpu.cli.evaluate import main as jevaluate
  from sisua_tpu_torch.cli.evaluate import main as tevaluate
  _patch_experimenters(monkeypatch, stores)
  jevaluate(["-model", "vae", "-path", str(tmp_path / "j"),
             "--summary-plots"])
  tevaluate(["-model", "vae", "-path", str(tmp_path / "t"), "--device",
             "cpu", "--summary-plots"])
  jfiles = sorted(os.listdir(tmp_path / "j"))
  assert sorted(os.listdir(tmp_path / "t")) == jfiles
  assert sum(f.endswith(".png") for f in jfiles) > 15


def test_cross_analyze_writes_the_jax_figures(stores, tmp_path, monkeypatch):
  from sisua_tpu.cross_analyze import main as jcross
  from sisua_tpu_torch.cross_analyze import main as tcross
  _patch_experimenters(monkeypatch, stores)
  js = jcross(["-model", "vae", "-ds", "synthetic200", "-path",
               str(tmp_path / "j")])
  ts = tcross(["-model", "vae", "-ds", "synthetic200", "-path",
               str(tmp_path / "t"), "--device", "cpu"])
  assert list(ts) == list(js)
  jfiles = sorted(os.listdir(tmp_path / "j"))
  assert sorted(os.listdir(tmp_path / "t")) == jfiles
  assert "cross_scores.csv" in jfiles and any(f.endswith(".png")
                                              for f in jfiles)
