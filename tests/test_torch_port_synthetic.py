"""The port's data layer and YAML reader against the JAX package's:
the numpy synthetic generators (bitwise), ``SingleCellOMIC.split`` and
``corrupt`` (bitwise, with the library statistics), the registry, the CSV
reader against pandas, and ``train/_yaml.py`` against PyYAML on every
file under ``configs/`` and a list of scalars PyYAML resolves by YAML 1.1's
rules."""

import glob
import math
import os

import numpy as np
import pandas as pd
import pytest
import yaml
from scipy import sparse

import sisua_tpu.data as JD
import sisua_tpu_torch.data as TD
from sisua_tpu_torch.train import _yaml as TY

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _same_matrix(a, b):
  """Bitwise: the same kind, dtype, shape and bits (CSR structure too)."""
  assert sparse.issparse(a) == sparse.issparse(b)
  if sparse.issparse(a):
    a, b = a.tocsr(), b.tocsr()
    assert a.dtype == b.dtype and a.shape == b.shape
    for f in ("indptr", "indices", "data"):
      np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
  else:
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _same_container(jsco, tsco):
  assert tsco.name == jsco.name
  assert tsco.omics == list(jsco.omics)
  assert tsco.n_obs == jsco.n_obs
  np.testing.assert_array_equal(tsco.obs["cell_id"],
                                np.asarray(jsco.obs.index, str))
  np.testing.assert_array_equal(tsco.obs["indices"],
                                jsco.obs["indices"].values)
  for o in jsco.omics:
    _same_matrix(jsco.get_omic(o), tsco.get_omic(o))
    assert list(tsco.get_var_names(o)) == [str(v) for v in
                                           jsco.get_var_names(o)]
    np.testing.assert_array_equal(tsco.get_library_size(o),
                                  jsco.get_library_size(o))


@pytest.mark.parametrize("name, kwargs", [
    ("generate_synthetic", dict(n_cells=200, n_genes=40, n_proteins=6)),
    ("generate_synthetic", dict(n_cells=150, n_genes=30, n_proteins=12,
                                n_celltypes=3, sparse_format=False, seed=3)),
    ("generate_citeseq", dict(n_cells=120, n_genes=40, n_proteins=6,
                              n_factors=5)),
    ("generate_citeseq", dict(n_cells=100, n_genes=30, n_proteins=8,
                              n_factors=6, weak_factors=2, n_nuisance=3,
                              zero_inflation=0.0, seed=9)),
    ("generate_multiome", dict(n_cells=90, n_genes=30, n_regions=50)),
    ("generate_multiome", dict(n_cells=80, n_genes=20, n_regions=40,
                               unpaired_frac=0.25, seed=11)),
])
def test_generators_bitwise_equal_jax(name, kwargs):
  jsco = getattr(JD, name)(**kwargs)
  tsco = getattr(TD, name)(**kwargs)
  _same_container(jsco, tsco)
  if "batch" in jsco.obs:
    np.testing.assert_array_equal(tsco.obs["batch"], jsco.obs["batch"].values)


def test_registry_synthetic_names_and_the_rest():
  """The port's registry is the JAX registry's synthetic family; every
  other JAX name raises with the reason, and files that need h5py too."""
  jmeta = JD.get_dataset_meta()
  avail = JD.get_dataset_availability()
  always = {k for k, v in avail.items() if v == "always"}
  assert set(TD.get_dataset_meta()) == always
  from sisua_tpu_torch.data import _DOWNLOADED
  assert _DOWNLOADED == set(jmeta) - always
  _same_container(JD.get_dataset("synthetic200"),
                  TD.get_dataset("Synthetic200"))
  for name in ("cortex", "8kly", "pbmcciteseq", "pbmc4k"):
    with pytest.raises(NotImplementedError, match="downloads"):
      TD.get_dataset(name)
  with pytest.raises(KeyError, match="Unknown dataset"):
    TD.get_dataset("synthetc")


def test_registry_files_that_need_h5py_raise(tmp_path):
  for fname in ("x.h5ad", "x.h5"):
    p = tmp_path / fname
    p.write_bytes(b"")
    with pytest.raises(NotImplementedError, match="h5py"):
      TD.get_dataset(str(p))
  d = tmp_path / "tenx"
  d.mkdir()
  (d / "matrix.mtx").write_text("")
  with pytest.raises(NotImplementedError, match="10x"):
    TD.get_dataset(str(d))


@pytest.mark.parametrize("seed", [5218, 1])
def test_split_and_corrupt_bitwise_equal_jax(seed):
  """split at the JAX seed, then corrupt the train part at seed 8: the
  same rows, names, counts and recomputed library statistics; the test
  part keeps the whole dataset's statistics, as in the JAX container."""
  jsco = JD.generate_synthetic(n_cells=300, n_genes=60, n_proteins=5)
  tsco = TD.generate_synthetic(n_cells=300, n_genes=60, n_proteins=5)
  (jtr, jte), (ttr, tte) = jsco.split(0.8, seed=seed), tsco.split(0.8,
                                                                 seed=seed)
  _same_container(jtr, ttr)
  _same_container(jte, tte)
  (jtr2, jva), (ttr2, tva) = jtr.split(0.9), ttr.split(0.9)
  jtr2.corrupt(dropout_rate=0.25, retain_rate=0.2)
  ttr2.corrupt(dropout_rate=0.25, retain_rate=0.2)
  _same_container(jtr2, ttr2)
  _same_container(jva, tva)
  assert not np.array_equal(ttr2.get_library_size(), tva.get_library_size())
  # not in place: the source is untouched
  jc = jte.corrupt(omic="proteomic", inplace=False, dropout_rate=0.5)
  tc = tte.corrupt(omic="proteomic", inplace=False, dropout_rate=0.5)
  _same_container(jc, tc)
  _same_container(jte, tte)


def test_get_rv_and_feeder_match_jax():
  jsco = JD.generate_multiome(n_cells=60, n_genes=20, n_regions=30)
  tsco = TD.generate_multiome(n_cells=60, n_genes=20, n_regions=30)
  tsco.add_omic("proteomic", np.eye(3, dtype=np.float32)[np.arange(60) % 3])
  jsco.add_omic("proteomic", np.eye(3, dtype=np.float32)[np.arange(60) % 3])
  for o in jsco.omics:
    j, t = jsco.get_rv(o), tsco.get_rv(o)
    assert (t.dim, t.posterior, t.name) == (j.dim, j.posterior, j.name)
  jf = jsco.create_dataset(omics=["transcriptomic", "celltype"],
                           labels_percent=0.5, batch_size=16)
  tf = tsco.create_dataset(omics=["transcriptomic", "celltype"],
                           labels_percent=0.5, batch_size=16)
  np.testing.assert_array_equal(tf.library, jf.library)
  assert (tf.labels_percent, tf.batch_size) == (jf.labels_percent,
                                                jf.batch_size)


def test_duplicate_var_names_deduped_as_pandas():
  names = ["a", "b", "a", "a.1", "a", "b"]
  x = np.ones((4, len(names)), np.float32)
  j = JD.SingleCellOMIC(x, gene_id=names)
  t = TD.SingleCellOMIC(x, gene_id=names)
  assert list(t.get_var_names()) == [str(v) for v in j.get_var_names()]


def test_csv_reader_matches_pandas(tmp_path):
  rng = np.random.default_rng(0)
  df = pd.DataFrame(rng.poisson(3, (7, 5)).astype(np.float32),
                    index=[f"c{i}" for i in range(7)],
                    columns=["g0", "g 1", "g,2", "g3", "g4"])
  df.iloc[2, 3] = np.nan
  for name, kw in (("m.csv", {}), ("m.csv.gz", {"compression": "gzip"})):
    p = str(tmp_path / name)
    df.to_csv(p, **kw)
    np.testing.assert_array_equal(
        TD.utils.read_csv_matrix(p),
        pd.read_csv(p, index_col=0).to_numpy(np.float32))


# ---------------------------------------------------------------------------
# YAML
# ---------------------------------------------------------------------------
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "**", "*.yaml"),
                           recursive=True))

TRICKY = ["1e-3", "1.0e-3", "1.e5", "3.", ".5", "-1.5e+3", "1_000.5",
          ".inf", "-.Inf", ".NaN", "yes", "No", "ON", "off",
          "True", "y", "n", "~", "null", "NULL", "", "09", "0.5:30",
          "+12", "-0", "1_000", "2001-12-1", "'0x1F'", "'2001-12-14'",
          "'a, b'", '"hello, world"',
          "[64, 64]", "[64,64]", "{}", "[]", "{a: 1, b: [1, 2]}",
          "{units: [64, 64], batchnorm: true, n: ~}", "'it''s'",
          '"tab\\tx\\u00e9"', "a b c", "foo#bar", "x # comment",
          "http://x.y/z", "[a, 'b, c', \"d]\"]", "'1e-3'", "'yes'"]
REFUSED = ["0x1F", "0b101", "017", "-017", "1:30", "190:20:30.15",
           "2001-12-14", "2001-12-14t21:59:43.10-05:00",
           "2001-12-14 21:59:43.10"]


@pytest.mark.parametrize("path", CONFIGS,
                         ids=[os.path.relpath(p, REPO) for p in CONFIGS])
def test_yaml_reads_every_config_as_pyyaml(path):
  with open(path) as f:
    text = f.read()
  want = yaml.safe_load(text)
  assert TY.safe_load(text) == want
  dumped = TY.safe_dump(want)
  assert dumped == yaml.safe_dump(want)  # the same text PyYAML writes
  assert yaml.safe_load(dumped) == want and TY.safe_load(dumped) == want


def test_yaml_scalars_resolve_as_pyyaml():
  """Each scalar as a value, and (the plain ones) as a key."""
  def same(want, got, s):
    if isinstance(want, float) and math.isnan(want):
      assert isinstance(got, float) and math.isnan(got), s
    else:
      assert got == want and type(got) is type(want), (s, want, got)

  for s in TRICKY:
    src = f"k: {s}\n"
    same(yaml.safe_load(src)["k"], TY.safe_load(src)["k"], s)
    if s and s[0] not in "[{'\"" and "#" not in s:
      want = yaml.safe_load(f"{s}: 1\n")
      got = TY.safe_load(f"{s}: 1\n")
      (wk, wv), = want.items()
      (gk, gv), = got.items()
      same(wk, gk, s)
      assert gv == wv == 1


def test_yaml_round_trips_through_both_libraries():
  obj = {"model": {"name": "sisua", "encoder": {"units": [64, 64]},
                   "note": "a: b, c # d", "quoted": "it's", "e": 1e-05,
                   "f": float("inf"), "g": -3, "h": None, "i": True,
                   "s1": "1e-3", "s2": "yes", "s3": "2001-01-01", "s4": "",
                   "s5": " lead", "s6": "line\nbreak", "s7": "<<",
                   "empty_d": {}, "empty_l": []},
         "seq": [{"a": 1, "b": [1, [2, 3]]}, [4, 5], "x"], 5: "int key"}
  text = TY.safe_dump(obj)
  assert yaml.safe_load(text) == obj
  assert TY.safe_load(text) == obj
  del obj["model"]["s6"]  # PyYAML writes a line break across lines
  assert TY.safe_load(yaml.dump(obj)) == obj


def test_yaml_refuses_what_it_does_not_read():
  for text in ("a: |\n  x\n", "a: &x 1\nb: *x\n", "a: !!str 1\n",
               "a: b\n  c\n", "k: -\n"):
    with pytest.raises(TY.YAMLError):
      TY.safe_load(text)
  # scalars PyYAML reads as non-decimal or base-60 numbers or timestamps,
  # as a value and as a key; written, they are quoted and read back
  for s in REFUSED:
    assert not isinstance(yaml.safe_load(f"k: {s}\n")["k"], str), s
    for text in (f"k: {s}\n", f"{s}: 1\n", f"k: [{s}]\n"):
      with pytest.raises(TY.YAMLError):
        TY.safe_load(text)
    dumped = TY.safe_dump({"k": s})
    assert TY.safe_load(dumped) == yaml.safe_load(dumped) == {"k": s}
