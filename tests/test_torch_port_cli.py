"""The port's entry points against the JAX package's, on the CPU
(``--device cpu``): ``sisua_tpu_torch.cli.train`` end to end beside the
JAX experimenter's ``run_config`` on the same config, ``get_models`` on
both packages' experiment directories, ``cli.predict``, ``cli.evaluate``,
``cli.embed`` and ``ResultsSheet`` (their figures: ``test_torch_port_
posterior_figures.py`` and ``test_torch_port_monitor_embed.py``); and
that the port imports none of the packages the card lacks."""

import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import yaml

import sisua_tpu.train.experimenter as JX
import sisua_tpu_torch.train.experimenter as TX
from torch_port_threads import _one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a 4-dim latent: the boosted trees of the DCI score, which grow on the
# host over every latent dim, set the cost of each posterior
OVERRIDES = ["model.name=vae", "dataset.name=synthetic500", "train.epochs=1",
             "variables.latents.event_shape=4"]


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
  """One experiment of the JAX experimenter, and the same config through
  the port's CLI in a fresh interpreter (``SISUA_EXP`` → its store)."""
  root = tmp_path_factory.mktemp("stores")
  jexp = JX.SisuaExperimenter(save_path=str(root / "j"))
  jscores = jexp.run_config(jexp.load_config(
      JX.parse_overrides(OVERRIDES)[0]))
  # the port's CLI in one thread too (see _one_thread)
  env = dict(os.environ, SISUA_EXP=str(root / "t"), OMP_NUM_THREADS="1",
             OPENBLAS_NUM_THREADS="1", MKL_NUM_THREADS="1")
  proc = subprocess.run(
      [sys.executable, "-m", "sisua_tpu_torch.cli.train", *OVERRIDES,
       "--device", "cpu"], cwd=REPO, env=env, capture_output=True,
      text=True, timeout=600)
  return dict(root=root, jexp=jexp, jscores=jscores, proc=proc,
              jdir=str(root / "j"), tdir=str(root / "t"))


def _exp_dirs(store):
  return sorted(d for d in os.listdir(store) if d != "scoreboard.db")


def test_train_cli_end_to_end_as_jax(stores):
  proc = stores["proc"]
  assert proc.returncode == 0, proc.stdout + proc.stderr
  assert " - device : cpu" in proc.stdout
  (jname,), (tname,) = _exp_dirs(stores["jdir"]), _exp_dirs(stores["tdir"])
  assert tname == jname
  tdir = os.path.join(stores["tdir"], tname)
  jdir = os.path.join(stores["jdir"], jname)
  for f in ("config.yaml", "model/metamodel.json", "model/params.msgpack",
            "model/history.json", "scores.json"):
    assert os.path.isfile(os.path.join(tdir, f)), f
  with open(os.path.join(tdir, "config.yaml")) as a, \
      open(os.path.join(jdir, "config.yaml")) as b:
    assert yaml.safe_load(a) == yaml.safe_load(b)
  with open(os.path.join(tdir, "scores.json")) as a, \
      open(os.path.join(jdir, "scores.json")) as b:
    tscores, jscores = json.load(a), json.load(b)
  assert set(tscores) == set(jscores)
  assert all(np.isfinite(v) for v in tscores.values())
  tsb = TX.ScoreBoard(os.path.join(stores["tdir"], "scoreboard.db"))
  rows = tsb.read_scores("scores_synthetic500")
  assert list(rows) == [tname]
  assert set(rows[tname]) == set(stores["jscores"])
  assert all(np.isfinite(v) for v in rows[tname].values())
  assert tsb.read_errors() == []


def test_get_models_rebuilds_both_packages_models(stores):
  import sisua_tpu_torch.convert as convert
  texp = TX.SisuaExperimenter(save_path=stores["tdir"], device="cpu")
  (cfg, model), = texp.get_models("model.name=vae dataset.name=synthetic500")
  assert cfg["model"]["name"] == "vae" and str(model.device) == "cpu"
  assert type(model).__name__ == "VAE" and len(model.outputs) == 1
  assert texp.get_models("model.name=dca") == []
  # the JAX experimenter's directory: the same weights as JAX reads them
  (jcfg, tmodel), = TX.SisuaExperimenter(
      save_path=stores["jdir"], device="cpu").get_models("model.name=vae")
  (_, jmodel), = stores["jexp"].get_models("model.name=vae")
  params, stats = convert.torch_to_jax(tmodel.module)
  jparams = jmodel._state.params

  def leaves(tree, prefix=()):
    for k, v in tree.items():
      if isinstance(v, dict):
        yield from leaves(v, prefix + (k,))
      else:
        yield prefix + (k,), np.asarray(v)

  want = dict(leaves(jparams))
  got = dict(leaves(params))
  assert set(got) == set(want)
  for k in want:
    np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))
  assert tmodel.history["loss"] == pytest.approx(jmodel.history["loss"])


def test_predict_cli_writes_what_jax_writes(stores, tmp_path):
  from scipy import sparse

  from sisua_tpu.cli.predict import main as jpredict
  from sisua_tpu_torch.cli.predict import main as tpredict
  from sisua_tpu_torch.data import get_dataset
  ckpt = os.path.join(stores["jdir"], _exp_dirs(stores["jdir"])[0], "model")
  test = get_dataset("synthetic500").split(0.8)[1]
  x = test.numpy()
  npz = str(tmp_path / "counts.npz")
  np.savez(npz, X=x)
  jm = jpredict([ckpt, npz, "-o", str(tmp_path / "j"), "--sample-shape",
                 "2"])
  tm = tpredict([ckpt, npz, "-o", str(tmp_path / "t"), "--sample-shape",
                 "2", "--device", "cpu"])
  assert tm == jm
  for f in ("imputed.npz", "latents.npz"):
    a, b = np.load(tmp_path / "j" / f), np.load(tmp_path / "t" / f)
    assert sorted(a) == sorted(b)
    for k in a:
      assert a[k].shape == b[k].shape and np.isfinite(b[k]).all()
  # the other inputs: a sparse npz, a CSV, a registry name
  sparse.save_npz(str(tmp_path / "sp.npz"), sparse.csr_matrix(x))
  pd.DataFrame(x, index=[f"c{i}" for i in range(len(x))]).to_csv(
      tmp_path / "counts.csv")
  for inp in (str(tmp_path / "sp.npz"), str(tmp_path / "counts.csv"),
              "synthetic500"):
    m = tpredict([ckpt, inp, "-o", str(tmp_path / "o"), "--sample-shape",
                  "1", "--device", "cpu"])
    assert m["outputs"] == [[m["n_cells"], 500]]
  # an .h5ad, as the JAX command reads it: the JAX command's manifest and
  # array shapes, and the arrays the port writes for the same cells given
  # as an npz (the same omic, rows in order)
  from sisua_tpu_torch.data import write_h5ad
  h5ad = str(tmp_path / "test.h5ad")
  write_h5ad(test, h5ad)
  jh = jpredict([ckpt, h5ad, "-o", str(tmp_path / "jh"), "--sample-shape",
                 "1"])
  th = tpredict([ckpt, h5ad, "-o", str(tmp_path / "th"), "--sample-shape",
                 "1", "--device", "cpu"])
  t1 = tpredict([ckpt, npz, "-o", str(tmp_path / "t1"), "--sample-shape",
                 "1", "--device", "cpu"])
  assert th == jh == t1 and th["n_cells"] == test.n_obs
  for f in ("imputed.npz", "latents.npz"):
    a, b = np.load(tmp_path / "jh" / f), np.load(tmp_path / "th" / f)
    c = np.load(tmp_path / "t1" / f)
    assert sorted(a) == sorted(b) == sorted(c)
    for k in a:
      assert a[k].shape == b[k].shape and np.isfinite(b[k]).all()
      np.testing.assert_array_equal(b[k], c[k], err_msg=f"{f}:{k}")
  # --mesh 2 --device cpu: two gloo ranks started by the command; rank 0
  # writes what the single-device call writes
  mm = tpredict([ckpt, npz, "-o", str(tmp_path / "m"), "--sample-shape",
                 "2", "--device", "cpu", "--mesh", "2"])
  assert mm == tm
  for f in ("imputed.npz", "latents.npz"):
    a, b = np.load(tmp_path / "t" / f), np.load(tmp_path / "m" / f)
    for k in a:
      np.testing.assert_allclose(b[k], a[k], rtol=1e-5, atol=1e-6)


def test_evaluate_cli_refuses_plots_and_writes_rows(stores, tmp_path,
                                                    monkeypatch):
  """Without matplotlib the figures-on command stops before any model is
  scored, with an ImportError that names matplotlib; with ``--no-plots``
  it writes the score rows and table."""
  from sisua_tpu_torch.cli.evaluate import main as evaluate
  monkeypatch.setattr(TX.SisuaExperimenter, "get_models",
                      lambda *a, **k: pytest.fail("worked before refusing"))
  monkeypatch.setitem(sys.modules, "matplotlib", None)
  for extra in ([], ["--summary-plots"]):
    with pytest.raises(ImportError, match="matplotlib"):
      evaluate(["-model", "vae", "-ds", "synthetic500", "--device", "cpu",
                *extra])
  monkeypatch.undo()
  orig = TX.SisuaExperimenter.__init__
  monkeypatch.setattr(
      TX.SisuaExperimenter, "__init__",
      lambda self, save_path=None, config_path=TX.CONFIG_PATH, device="cuda":
      orig(self, save_path=stores["tdir"], config_path=config_path,
           device=device))
  # -ds2: scored on the test split of another dataset of the same genes
  # (200 cells: the score families' cost scales with the test rows)
  posts = evaluate(["-model", "vae", "-ds", "synthetic500", "-ds2",
                    "synthetic200", "-path", str(tmp_path), "--no-plots",
                    "--device", "cpu"])
  assert len(posts) == 1 and str(posts[0].scm.device) == "cpu"
  assert posts[0].name == "vae_synthetic200_test"
  sb = TX.ScoreBoard(os.path.join(stores["tdir"], "scoreboard.db"))
  rows = sb.read_scores("eval_synthetic200")
  assert list(rows) == ["vae_synthetic200"]
  assert any(k.startswith("llk") for k in rows["vae_synthetic200"])
  assert not sb.read_errors()
  table = pd.read_csv(tmp_path / "scores.csv", index_col=0)
  assert list(table.index) == [posts[0].name]
  assert (tmp_path / "scores.html").is_file()


def test_evaluate_cli_over_a_mesh_writes_the_single_device_table(
    stores, tmp_path, monkeypatch):
  """``sisua-evaluate --mesh 2 --no-plots --device cpu`` starts two gloo
  ranks (they find the store through ``SISUA_EXP``), scores the
  posterior's predictions over the mesh, and rank 0 writes the table
  the single-device command writes (rtol 1e-4)."""
  from sisua_tpu_torch.cli.evaluate import main as evaluate
  monkeypatch.setenv("SISUA_EXP", stores["tdir"])
  orig = TX.SisuaExperimenter.__init__
  monkeypatch.setattr(
      TX.SisuaExperimenter, "__init__",
      lambda self, save_path=None, config_path=TX.CONFIG_PATH, device="cuda":
      orig(self, save_path=stores["tdir"], config_path=config_path,
           device=device))
  args = ["-model", "vae", "-ds", "synthetic500", "-ds2", "synthetic200",
          "--no-plots", "--device", "cpu"]
  single = evaluate(args + ["-path", str(tmp_path / "single")])
  names = evaluate(args + ["-path", str(tmp_path / "mesh"), "--mesh", "2"])
  assert names == [p.name for p in single]
  a = pd.read_csv(tmp_path / "single" / "scores.csv", index_col=0)
  b = pd.read_csv(tmp_path / "mesh" / "scores.csv", index_col=0)
  assert list(a.columns) == list(b.columns) and list(a.index) == list(
      b.index)
  np.testing.assert_allclose(b.to_numpy(float), a.to_numpy(float),
                             rtol=1e-4, atol=1e-6)


def test_train_cli_over_a_two_rank_mesh_writes_the_single_device_scores(
    stores, tmp_path):
  """The fixture's config with ``train.n_data_devices=2``: the command
  starts two gloo ranks, trains and scores over the 2 × 1 mesh, and rank 0
  writes the scores of the single-device run: every key, finite, the
  likelihoods and the imputation's mean and median within 1e-3. The
  latent-space scores (clustering, DCI, MIG, correlations) are not held:
  k-means, the boosted trees and rank statistics turn the rounding-level
  differences of the training steps into different partitions (an Adam
  step moves a BatchNorm-fed bias by ±lr on its rounding-noise gradient:
  tests/test_torch_port_mesh.py)."""
  env = dict(os.environ, SISUA_EXP=str(tmp_path), OMP_NUM_THREADS="1",
             OPENBLAS_NUM_THREADS="1", MKL_NUM_THREADS="1")
  proc = subprocess.run(
      [sys.executable, "-m", "sisua_tpu_torch.cli.train", *OVERRIDES,
       "train.n_data_devices=2", "--device", "cpu"], cwd=REPO, env=env,
      capture_output=True, text=True, timeout=600)
  assert proc.returncode == 0, proc.stdout + proc.stderr
  assert proc.stdout.count("SisuaExperimenter:") == 1  # rank 0 prints
  (name,) = _exp_dirs(str(tmp_path))
  (want_name,) = _exp_dirs(stores["tdir"])
  assert name == want_name  # the train section is not in the hash
  with open(os.path.join(str(tmp_path), name, "scores.json")) as f:
    got = json.load(f)
  with open(os.path.join(stores["tdir"], name, "scores.json")) as f:
    want = json.load(f)
  assert sorted(got) == sorted(want)
  assert np.isfinite([got[k] for k in got]).all()
  for k in want:
    if k.startswith("llk") or k in ("imputation_mean", "imputation_med"):
      np.testing.assert_allclose(got[k], want[k], rtol=1e-3, err_msg=k)


def test_results_sheet_table_parses_as_jax(tmp_path):
  """Two posteriors of one name and different metrics: the same rows,
  columns and NaNs as the JAX sheet's CSV."""
  from sisua_tpu.analysis import Posterior as JP
  from sisua_tpu.analysis import ResultsSheet as JR
  from sisua_tpu_torch.analysis import Posterior as TP
  from sisua_tpu_torch.analysis import ResultsSheet as TR
  scores = [("vae_x", {"llk": -1.5, "f1": 0.25}),
            ("vae_x", {"llk": -2.0, "mi": float("nan")}),
            ("dca_x", {"mi": 1.0 / 3.0})]

  def fakes(cls):
    out = []
    for name, sc in scores:
      p = cls.__new__(cls)
      p._name = name
      p.save_scores = (lambda sc=sc: dict(sc))
      out.append(p)
    return out

  JR(*fakes(JP)).save_scores(str(tmp_path / "j" / "scores"))
  sheet = TR(*fakes(TP))
  assert sheet.names == ["vae_x", "vae_x_1", "dca_x"]
  sheet.save_scores(str(tmp_path / "t" / "scores.csv"))
  j = pd.read_csv(tmp_path / "j" / "scores.csv", index_col=0)
  t = pd.read_csv(tmp_path / "t" / "scores.csv", index_col=0)
  assert list(t.index) == list(j.index)
  assert set(t.columns) == set(j.columns)
  pd.testing.assert_frame_equal(t[sorted(t.columns)], j[sorted(j.columns)])
  assert (tmp_path / "t" / "scores.html").is_file()
  assert sheet.get_scores()["vae_x_1"]["llk"] == -2.0


def test_embed_cli_refuses_figures_and_writes_three_files(tmp_path,
                                                           monkeypatch):
  """Without matplotlib the figures-on command stops before any work,
  naming matplotlib; with ``--no-figures`` it writes the three files the
  JAX command writes (with figures: ``test_torch_port_monitor_embed``)."""
  from sisua_tpu.label_threshold import main as jembed
  from sisua_tpu_torch.cli.embed import main as tembed
  with monkeypatch.context() as m:
    m.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
      tembed(["synthetic200", "-o", str(tmp_path / "t"), "--device", "cpu"])
  assert not (tmp_path / "t").exists()
  tembed(["synthetic200", "-o", str(tmp_path / "t"), "--no-figures",
          "--device", "cpu"])
  jembed(["synthetic200", "-o", str(tmp_path / "j"), "--no-figures"])
  assert sorted(os.listdir(tmp_path / "t")) == sorted(
      os.listdir(tmp_path / "j")) == ["model.pkl", "y_bin", "y_prob"]
  for f in ("y_bin", "y_prob"):
    with open(tmp_path / "t" / f, "rb") as a, open(tmp_path / "j" / f,
                                                  "rb") as b:
      t, j = pickle.load(a), pickle.load(b)
    assert t.shape == j.shape == (200, 10)
    if f == "y_bin":
      np.testing.assert_array_equal(t, j)
  assert (tmp_path / "t" / "model.pkl").is_file()
  # a CSV of proteins
  from sisua_tpu_torch.data import get_dataset
  y = get_dataset("synthetic200").numpy("proteomic")
  pd.DataFrame(y, columns=[f"p{i}" for i in range(10)]).to_csv(
      tmp_path / "p.csv")
  tembed([str(tmp_path / "p.csv"), "-o", str(tmp_path / "c"),
          "--no-figures", "--device", "cpu"])
  with open(tmp_path / "c" / "y_bin", "rb") as f:
    np.testing.assert_array_equal(pickle.load(f),
                                  pickle.load(open(tmp_path / "t" / "y_bin",
                                                   "rb")))


_BLOCKER = """
import importlib.abc, os, sys
os.environ["OMP_NUM_THREADS"] = "1"   # t-SNE's and LARS's OpenMP teams
BLOCKED = {"jax", "jaxlib", "flax", "optax", "pandas", "yaml", "sklearn",
           "h5py", "matplotlib", "cryptography", "scvi", "anndata", "rpy2",
           "sisua_tpu"}
class Block(importlib.abc.MetaPathFinder):
  def find_spec(self, name, path=None, target=None):
    if name.split(".")[0] in BLOCKED:
      raise ImportError(f"{name} is blocked")
sys.meta_path.insert(0, Block())
import pkgutil, importlib, sisua_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(sisua_tpu_torch.__path__,
                                              "sisua_tpu_torch.")]
for m in mods:
  importlib.import_module(m)
import sisua_tpu_torch.cli.train
for m in ("data.analysis", "data.umap_impl", "analysis.decomposition",
          "analysis.cluster", "analysis.stats", "utils", "utils.others",
          "utils.io_utils", "baselines", "analysis.manifold",
          "analysis.lars", "data.loaders.misc", "data.h5ad",
          "data.sisua_to_scvi"):
  assert "sisua_tpu_torch." + m in mods, m
# the analyzer's methods import lazily: run each once on the CPU (one
# thread: the tier runs several test processes on the machine's cores)
import tempfile
import numpy as np
import torch
torch.set_num_threads(1)
from sisua_tpu_torch.data import generate_synthetic
from sisua_tpu_torch import utils
s = generate_synthetic(n_cells=200, n_genes=60, n_proteins=3,
                       n_celltypes=3, seed=1)
kw = dict(device="cpu")
s.calculate_quality_metrics(**kw)
s.filter_highly_variable_genes(n_top_genes=40, **kw)
s.normalize(total=True, log1p=True, **kw)
s.dimension_reduce(n_components=20, **kw)
s.dimension_reduce(algo="umap", n_components=2, **kw)
s.dimension_reduce(algo="tsne", **kw)
s.louvain(**kw)
for algo in ("kmeans", "agglo", "spectral"):
  s.clustering(algo=algo, matching_labels="celltype", **kw)
for method in ("t-test", "wilcoxon"):
  s.rank_vars_groups(method=method, **kw)
s.get_correlation(**kw)
s.get_mutual_information(**kw)
s.get_mutual_information(backend="jax", **kw)
s.get_importance_matrix(n_estimators=2)
s.probabilistic_embedding("proteomic", **kw)
utils.save_data_to_csv(s, tempfile.mkdtemp() + "/x.csv.gz")
from sisua_tpu_torch.baselines import BASELINE_MODELS, run_baseline
for m in BASELINE_MODELS:
  run_baseline(s, m, n_components=4, **kw)
# the data-ingestion layer: a 10x directory, then a registry name from a
# placed raw tree (parsed, cached, then read back as a cache hit)
import gzip, tarfile
from scipy import io as sp_io, sparse
root = tempfile.mkdtemp()
d = os.path.join(root, "filtered_feature_bc_matrix")
os.makedirs(d)
x = np.random.default_rng(0).poisson(1.0, (9, 30)).astype(np.float32)
with gzip.open(os.path.join(d, "matrix.mtx.gz"), "wb") as f:
  sp_io.mmwrite(f, sparse.coo_matrix(x))  # features × cells
with gzip.open(os.path.join(d, "barcodes.tsv.gz"), "wt") as f:
  f.write("".join(f"B{i}-1\\n" for i in range(30)))
with gzip.open(os.path.join(d, "features.tsv.gz"), "wt") as f:
  f.write("".join(f"E{j}\\tG{j}\\t"
                  f"{'Antibody Capture' if j > 6 else 'Gene Expression'}\\n"
                  for j in range(9)))
from sisua_tpu_torch.data import get_dataset, OMIC
from sisua_tpu_torch.data.loaders import tenx
a = get_dataset(d)
assert a.omics == ["transcriptomic", "proteomic"] and a.shape == (30, 7)
tenx.DATA_DIR, tenx.DOWNLOAD_DIR = os.path.join(root, "data"), root
with tarfile.open(os.path.join(
    root, "pbmc_10k_protein_v3_filtered_feature_bc_matrix.tar.gz"),
    "w:gz") as t:
  t.add(d, arcname="filtered_feature_bc_matrix")
b = get_dataset("10k")
def refuse(*a, **k):
  raise AssertionError("cache miss")
tenx.download_file = refuse
c = get_dataset("10k")
assert a.md5 == b.md5 == c.md5 and c.get_dim(OMIC.proteomic) == 2
assert not BLOCKED & {k.split(".")[0] for k in sys.modules}
print(len(mods))
"""


def test_port_imports_none_of_what_the_card_lacks():
  """Every module of the port (``cli``, the data analyzer, ``utils``, the
  baselines and the loaders too) imports with jax, pandas, yaml, sklearn,
  h5py, matplotlib, cryptography, scvi-tools, anndata, rpy2 and the JAX
  package unimportable, and each analyzer method (t-SNE too), each
  baseline and ``get_dataset`` on a 10x directory and on a registry name
  from a placed raw tree run so."""
  proc = subprocess.run([sys.executable, "-c", _BLOCKER], cwd=REPO,
                        capture_output=True, text=True, timeout=300)
  assert proc.returncode == 0, proc.stderr
  assert int(proc.stdout.split()[-1]) > 40
