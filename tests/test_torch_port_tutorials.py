"""The tutorials on the port (``sisua_tpu_torch/tutorials``) against the
JAX tutorials (``tutorials/``), on the CPU.

* Each tutorial's ``main(device='cpu', depth=1)`` at the JAX tutorial's
  widths (cells, genes, proteins, latent and hidden sizes, batch sizes):
  the keys of what the JAX tutorial prints, every number finite; the
  save/load round trip within the JAX tutorial's rtol 1e-6. The notebook's
  code cells in order, and one tutorial through its command line.
* The steps that do not depend on training, bitwise the same JAX
  computation on the same seed: the datasets and their splits, the
  ablated panel and its labels binarized once at full scale, the
  CellAssign marker panel and ``rho``, SOLO's pair sums, the out-of-core
  CSR and the experimenter's grid of configs.
* Each model a tutorial builds against the JAX model built from the same
  arguments: the flax init (traced for shapes) converted with
  ``convert.jax_to_torch``, every parameter and statistic name and shape.
"""

import functools
import math
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import scipy.sparse as sp

import sisua_tpu.data as JD
import sisua_tpu.models as JM
from sisua_tpu.interpolation import linear as jlinear
from sisua_tpu.label_threshold import ProbabilisticEmbedding as JPE
from sisua_tpu.train.experimenter import SisuaExperimenter as JExperimenter
import sisua_tpu_torch.data as TD
from sisua_tpu_torch import convert
from sisua_tpu_torch.tutorials import (TUTORIALS, basics, bayes_search,
                                       cross_datasets, grid_search,
                                       missing_protein, multiple_models,
                                       performance, qc_annotation,
                                       real_data_drill, save_and_load_models,
                                       serving, uncertainty_analysis)
from sisua_tpu_torch.tutorials import notebook
from sisua_tpu_torch.train.experimenter import SisuaExperimenter

from torch_port_threads import _one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# what each JAX tutorial prints, under the port tutorial's keys
KEYS = {
    "basics": {"vae", "sisua", "sheet", "sheet_figures"},
    "serving": {"imputed", "latents", "bf16_median_rel_err",
                "rows_sum_to_1"},
    "save_and_load_models": {"saved", "history_epochs",
                             "latent_mean_max_rel", "output_mean_max_rel"},
    "uncertainty_analysis": {"posterior_mean_shape", "mean_per_gene_std",
                             "mean_latent_stddev", "llk", "marginal_llk",
                             "figures"},
    "missing_protein": {"training_panel", "held_out", "f1"},
    "probabilistic_embedding": {"proteins", "counts_shape", "positive_rate",
                                "container_agrees"},
    "cross_datasets": {"in-cohort (A)", "cross-cohort (B)"},
    "multiple_models": {"final_loss", "sheet", "figures"},
    "qc_annotation": {"autozi", "solo", "cellassign"},
    "performance": {"window_losses", "cells_per_sec", "bf16_loss",
                    "param_dtype", "hyper_best", "hyper_loss",
                    "imputed_means", "latents", "orbax",
                    "out_of_core_losses"},
    "bayes_search": {"tpe_best", "tpe_loss", "tpe_trials", "vmap_best",
                     "vmap_loss", "extracted"},
    "grid_search": {"scores", "reloaded"},
    "real_data_drill": {"format", "scores_files", "tables"},
    "notebook": {"n_genes", "n_prots", "protein_prediction", "sheet",
                 "median_epoch_seconds", "library_draws"},
}


def _numbers(obj, path="result"):
  """Every number in a tutorial's result, with where it lies."""
  if isinstance(obj, dict):
    for k, v in obj.items():
      yield from _numbers(v, f"{path}[{k!r}]")
  elif isinstance(obj, (list, tuple)):
    for i, v in enumerate(obj):
      yield from _numbers(v, f"{path}[{i}]")
  elif isinstance(obj, (bool, str)) or obj is None:
    return
  else:
    yield path, float(np.asarray(obj, np.float64))


def _module(name):
  import importlib
  return importlib.import_module(f"sisua_tpu_torch.tutorials.{name}")


@pytest.mark.parametrize("name", list(TUTORIALS) + ["notebook"])
def test_tutorial_runs_on_the_cpu(name, tmp_path, monkeypatch):
  monkeypatch.setenv("OMP_NUM_THREADS", "1")   # the drill's stages
  result = _module(name).main(device="cpu", out_dir=str(tmp_path), depth=1)
  assert set(result) == KEYS[name]
  bad = [p for p, v in _numbers(result) if not math.isfinite(v)]
  assert not bad, f"not finite: {bad}"
  if name == "save_and_load_models":
    assert result["latent_mean_max_rel"] <= 1e-6
    assert result["output_mean_max_rel"] <= 1e-6
    assert {"params.msgpack", "metamodel.json"} <= set(result["saved"])
  if name == "performance":
    assert result["param_dtype"] == "torch.float32"
    assert "not ported" in result["orbax"]
  if name == "serving":
    assert result["rows_sum_to_1"]
  if name == "probabilistic_embedding":
    assert result["container_agrees"]
  if name == "grid_search":
    assert len(result["scores"]) == 2 and result["reloaded"]
  if name == "real_data_drill":
    assert result["format"] == "10x" and "scores.csv" in result[
        "scores_files"]


def test_tutorial_command_line(tmp_path):
  env = dict(os.environ, OMP_NUM_THREADS="1",
             PYTHONPATH=os.pathsep.join([REPO, os.environ.get(
                 "PYTHONPATH", "")]))
  proc = subprocess.run(
      [sys.executable, "-m",
       "sisua_tpu_torch.tutorials.probabilistic_embedding", "--device",
       "cpu", "--out", str(tmp_path)], cwd=str(tmp_path), env=env,
      capture_output=True, text=True, timeout=300)
  assert proc.returncode == 0, proc.stderr
  assert "container call agrees: True" in proc.stdout


def test_drill_formats(tmp_path, monkeypatch):
  """'h5ad' writes through the port's h5ad writer (and names h5py where
  it is absent), '10x' a CellRanger directory that ``get_dataset`` reads
  back bitwise; no other format is taken."""
  sco = real_data_drill.user_data()
  path = real_data_drill.make_user_file(str(tmp_path), "10x")
  back = TD.get_dataset(path)
  for omic in ("transcriptomic", "proteomic"):
    a, b = back.get_omic(omic), sco.get_omic(omic)
    a = a.toarray() if sp.issparse(a) else a
    b = b.toarray() if sp.issparse(b) else b
    np.testing.assert_array_equal(a, b)
  assert list(back.obs_names) == list(sco.obs_names)
  pytest.importorskip("h5py")
  h5 = real_data_drill.make_user_file(str(tmp_path), "h5ad")
  assert h5.endswith(".h5ad") and os.path.isfile(h5)
  monkeypatch.setitem(sys.modules, "h5py", None)
  with pytest.raises(ImportError, match="h5py"):
    real_data_drill.make_user_file(str(tmp_path / "again"), "h5ad")
  with pytest.raises(ValueError):
    real_data_drill.make_user_file(str(tmp_path), "loom")


# ----------------------------------------------- steps that do not train
def _equal_sco(t, j, omics=("transcriptomic", "proteomic")):
  assert list(t.obs_names) == list(j.obs_names)
  for omic in omics:
    a, b = t.get_omic(omic), j.get_omic(omic)
    a = a.toarray() if sp.issparse(a) else np.asarray(a)
    b = b.toarray() if sp.issparse(b) else np.asarray(b)
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


@pytest.mark.parametrize("which", ["synthetic", "citeseq", "cohorts",
                                   "performance", "drill"])
def test_datasets_and_splits_equal_jax(which):
  if which == "synthetic":
    pairs = [(TD.get_dataset("synthetic"), JD.get_dataset("synthetic"),
              dict(train_percent=0.8))]
  elif which == "citeseq":
    kw = dict(n_cells=2048, n_genes=120, n_proteins=8, seed=0)
    pairs = [(TD.generate_citeseq(**kw), JD.generate_citeseq(**kw),
              dict(train_percent=0.8, seed=1))]
  elif which == "cohorts":
    ja = JD.generate_synthetic(n_cells=2000, n_genes=120, n_proteins=8,
                               n_celltypes=4, seed=1, name="cohortA")
    jb = JD.generate_synthetic(n_cells=1000, n_genes=120, n_proteins=8,
                               n_celltypes=4, seed=2, name="cohortB")
    ta, tb = cross_datasets.cohorts()
    _equal_sco(tb, jb)
    pairs = [(ta, ja, dict(train_percent=0.8))]
  elif which == "performance":
    t, _ = performance.data()
    pairs = [(t, JD.generate_synthetic(n_cells=2048, n_genes=100,
                                       n_proteins=8, seed=0),
              dict(train_percent=0.8, seed=1))]
  else:
    pairs = [(real_data_drill.user_data(),
              JD.generate_citeseq(n_cells=2000, n_genes=300, n_proteins=8,
                                  seed=1), None)]
  for t, j, split in pairs:
    _equal_sco(t, j)
    if split:
      for a, b in zip(t.split(**split), j.split(**split)):
        _equal_sco(a, b)


def test_ablated_panel_and_labels_equal_jax():
  js, ts = JD.get_dataset("synthetic"), TD.get_dataset("synthetic")
  ablated, full_y, names, keep = missing_protein.ablate(ts)
  # the JAX tutorial's own steps
  jfull = js.numpy(JD.OMIC.proteomic)
  jnames = np.asarray(js.get_var_names(JD.OMIC.proteomic))
  jkeep = np.setdiff1d(np.arange(len(jnames)), missing_protein.REMOVED)
  jab = js.copy()
  jab.add_omic(JD.OMIC.proteomic, jfull[:, jkeep], list(jnames[jkeep]))
  np.testing.assert_array_equal(keep, jkeep)
  assert list(names) == list(jnames)
  assert list(ablated.get_var_names("proteomic")) == list(
      jab.get_var_names("proteomic"))
  _equal_sco(ablated, jab)
  for a, b in zip(ablated.split(0.8), jab.split(0.8)):
    _equal_sco(a, b)
  y_train, y_test = missing_protein.held_out_labels(ts, full_y, "cpu")
  removed = missing_protein.REMOVED
  y_full = JPE().fit(jfull[:, removed]).predict(jfull[:, removed])
  pos = {n: i for i, n in enumerate(js.obs_names)}
  jtr, jte = js.split(0.8)
  np.testing.assert_array_equal(y_train,
                                y_full[[pos[n] for n in jtr.obs_names]])
  np.testing.assert_array_equal(y_test,
                                y_full[[pos[n] for n in jte.obs_names]])


def test_marker_panel_rho_and_pair_sums_equal_jax():
  js, ts = JD.get_dataset("synthetic"), TD.get_dataset("synthetic")
  x, jx = ts.numpy(), js.numpy()
  np.testing.assert_array_equal(x, jx)
  np.testing.assert_array_equal(qc_annotation.pair_sums(x),
                                jx[:50] + jx[50:100])
  y = js.numpy(JD.OMIC.celltype)
  types, C = np.argmax(y, -1), y.shape[1]
  np.testing.assert_array_equal(np.argmax(ts.numpy("celltype"), -1), types)
  panel, rho = qc_annotation.marker_panel(x, types, C)
  # the JAX tutorial's own steps
  half = jx.shape[0] // 2
  marker_idx = []
  for c in range(C):
    mu_c = jx[:half][types[:half] == c].mean(0)
    mu_rest = jx[:half][types[:half] != c].mean(0)
    fold = (mu_c + 1e-3) / (mu_rest + 1e-3)
    marker_idx.append(np.argsort(-fold)[:5])
  jpanel = np.unique(np.concatenate(marker_idx))
  jrho = np.zeros((len(jpanel), C), np.float32)
  for c, idx in enumerate(marker_idx):
    jrho[np.searchsorted(jpanel, idx), c] = 1.0
  np.testing.assert_array_equal(panel, jpanel)
  np.testing.assert_array_equal(rho, jrho)


def test_out_of_core_csr_equals_jax():
  _, (train, _) = performance.data()
  jtrain, _ = JD.generate_synthetic(n_cells=2048, n_genes=100, n_proteins=8,
                                    seed=0).split(0.8, seed=1)
  Xs = performance.train_csr(train)
  jXs = sp.csr_matrix(np.asarray(jtrain.X.todense()
                                 if sp.issparse(jtrain.X) else jtrain.X))
  for f in ("data", "indices", "indptr"):
    a, b = getattr(Xs, f), getattr(jXs, f)
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)
  # the forced budget of 8 batch-sized int16 chunks is below the dataset
  assert 8 * 128 * 2 * Xs.shape[1] < Xs.shape[0] * Xs.shape[1] * 2


@pytest.mark.parametrize("depth", [None, 1, 2])
def test_grid_of_configs_equals_jax(depth, tmp_path):
  """The grid's configs: the port experimenter's parse against the JAX
  experimenter's own steps (``parse_overrides``, then ``load_config``)."""
  from sisua_tpu.train.experimenter import config_hash, parse_overrides
  argv = grid_search.grid_args(depth)
  t = SisuaExperimenter(save_path=str(tmp_path / "t"), device="cpu")
  j = JExperimenter(save_path=str(tmp_path / "j"))
  tc, multirun, ncpu = t.parse_args(argv)
  jc = [j.load_config(g)
        for g in parse_overrides([a for a in argv if a != "-m"])]
  assert (multirun, ncpu) == (True, 1)
  assert tc == jc
  assert [config_hash(c) for c in tc] == [config_hash(c) for c in jc]
  assert len(tc) == {None: 6, 1: 2, 2: 4}[depth]


# ------------------------------------------------------ the architectures
def _jax_models():
  """(tutorial, port builder, JAX model) of every model the tutorials
  build, the JAX ones from the JAX tutorials' arguments."""
  RV, Net = JM.RVmeta, JM.NetConf
  syn = TD.get_dataset("synthetic")
  G = syn.n_vars
  lat10 = RV(10, "diag", name="latents")
  yield ("basics.vae", lambda: basics.build_vae(syn, "cpu"),
         lambda: JM.VAE(outputs=RV(G, "zinb", name="rna"), latents=lat10,
                        encoder=Net((64, 64), batchnorm=True,
                                    input_dropout=0.3)))
  sisua_jax = lambda g, p: JM.SISUA(  # noqa: E731
      outputs=[RV(g, "zinb", name="rna"), RV(p, "nb", name="adt")],
      latents=lat10)
  yield ("basics.sisua", lambda: basics.build_sisua(syn, "cpu"),
         lambda: sisua_jax(G, 10))
  cite = TD.generate_citeseq(n_cells=2048, n_genes=120, n_proteins=8,
                             seed=0).split(0.8, seed=1)[0]
  yield ("serving", lambda: serving.build(cite, "cpu"),
         lambda: JM.SCVI(RV(120, "zinbd", name="rna"),
                         latents=RV(16, "diag", name="latents")))
  yield ("save_and_load_models",
         lambda: save_and_load_models.build(syn, "cpu"),
         lambda: JM.SCVI(outputs=RV(G, "zinbd", name="rna"), latents=lat10,
                         encoder=Net((64, 64), batchnorm=True)))
  yield ("uncertainty_analysis",
         lambda: uncertainty_analysis.build(syn, "cpu"),
         lambda: JM.SCVI(outputs=RV(G, "zinbd", name="rna"), latents=lat10,
                         beta=jlinear(vmin=0.0, vmax=1.0, norm=20)))
  keep = missing_protein.ablate(syn)[3]
  yield ("missing_protein", lambda: missing_protein.build(syn, keep, "cpu"),
         lambda: sisua_jax(G, 8))
  ds_a = cross_datasets.cohorts()[0]
  yield ("cross_datasets", lambda: cross_datasets.build(ds_a, "cpu"),
         lambda: sisua_jax(120, 8))
  for name in multiple_models.FAMILIES:
    def jax_family(name=name):
      cls = JM.get_model(name)
      if cls.mask_outputs:
        return cls(outputs=[RV(G, "zinb", name="rna"),
                            RV(10, "nb", name="adt")], latents=lat10)
      return cls(outputs=RV(G, "zinbd" if name == "scvi" else "zinb",
                            name="rna"), latents=lat10)
    yield (f"multiple_models.{name}",
           lambda name=name: multiple_models.build(name, syn, "cpu"),
           jax_family)
  yield ("qc_annotation.autozi",
         lambda: qc_annotation.build_autozi(G, "cpu"),
         lambda: JM.AUTOZI(RV(G, "zinbd", name="rna"), encoder=Net((64,)),
                           decoder=Net((64,)), seed=0))
  yield ("qc_annotation.scvi", lambda: qc_annotation.build_scvi(G, "cpu"),
         lambda: JM.SCVI(RV(G, "zinbd", name="rna"), encoder=Net((64,)),
                         decoder=Net((64,)), seed=0))
  yield ("performance.scvi", lambda: performance.build_scvi("cpu"),
         lambda: JM.SCVI(RV(100, "zinbd", name="rna"),
                         latents=RV(16, "diag", name="latents")))
  yield ("performance.bf16", lambda: performance.build_bf16("cpu"),
         lambda: JM.VAE(RV(100, "zinb", name="rna"),
                        compute_dtype="bfloat16"))
  yield ("performance.member", lambda: performance.build_member(3, "cpu"),
         lambda: JM.VAE(RV(100, "zinb", name="rna"), seed=3,
                        encoder={"units": [32]}, decoder={"units": [32]}))
  yield ("performance.out_of_core",
         lambda: performance.build_out_of_core(100, "cpu"),
         lambda: JM.VAE(RV(100, "zinb", name="rna"), encoder=Net((64,)),
                        decoder=Net((64,))))
  yield ("bayes_search", lambda: bayes_search.build(G, 0, "cpu"),
         lambda: JM.VAE(RV(G, "zinb", name="rna"), latents=lat10, seed=0))


MODELS = ("basics.vae", "basics.sisua", "serving", "save_and_load_models",
          "uncertainty_analysis", "missing_protein", "cross_datasets",
          "multiple_models.vae", "multiple_models.dca",
          "multiple_models.scvi", "multiple_models.sisua",
          "qc_annotation.autozi", "qc_annotation.scvi", "performance.scvi",
          "performance.bf16", "performance.member",
          "performance.out_of_core", "bayes_search")


@functools.lru_cache(maxsize=None)
def _models():
  return {name: (port, jax_) for name, port, jax_ in _jax_models()}


def test_every_tutorial_model_is_listed():
  assert set(_models()) == set(MODELS)


@pytest.mark.parametrize("name", MODELS)
def test_tutorial_model_matches_the_jax_architecture(name):
  port_fn, jax_fn = _models()[name]
  tm, jm = port_fn(), jax_fn()
  x, lib = jm._dummy_batch()
  key = jax.random.key(0, impl="rbg")
  shapes = jax.eval_shape(lambda: jm.module.init(
      {"params": key, "sample": key, "dropout": key}, x, training=True,
      **jm._apply_kwargs(lib)))
  tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                dict(shapes))
  # raises on a leaf without a counterpart or of another shape, either side
  sd = convert.jax_to_torch(tm.module, tree["params"],
                            tree.get("batch_stats"))
  want = tm.module.state_dict()
  assert set(sd) == set(want)
  for k, v in sd.items():
    assert tuple(v.shape) == tuple(want[k].shape), k
  assert tm.compute_dtype == jm.compute_dtype
  assert type(tm).__name__ == type(jm).__name__
