"""The port's data-ingestion layer against the JAX package's, on the CPU:
every loader family the JAX suite drives offline, on the same tiny raw
tree placed under each package's own download folder (made with the JAX
tests' helpers where they exist), through each registry's
``get_dataset``: the same container (omics in order, every matrix exact,
var names and cell ids in order, the name, ``uns``, the library
statistics to rtol 1e-6), the same cache bytes (the npz files written at
one frozen time) and manifests; then the two data folders swapped, and
each package reads the other's cache as a cache hit with every download
refused. Also ``download_file``, the 10x readers (mtx plain, gzipped,
legacy v2, peaks; h5 v3 and v2), ``.h5ad`` across packages both ways,
``OMIC`` against JAX, the registry's names, loaders and availability,
and ``get_dataset_summary``. No test reaches the network:
``urllib.request.urlretrieve`` raises in every test of this file."""

import gzip
import importlib
import io
import os
import shutil
import tarfile
import time
import types
import zipfile

import numpy as np
import pandas as pd
import pytest
from scipy import io as sp_io
from scipy import sparse

import sisua_tpu.data as JD
import sisua_tpu_torch.data as TD
from sisua_tpu.data import utils as JU
from sisua_tpu_torch.data import utils as TU
from test_loaders_leukemia_pbmc import (_add_bytes, _author_npz, _gz_bytes,
                                        _mtx_gz_bytes)
from test_loaders_offline import (_gene_table, _make_10x_archive,
                                  _make_winzip_aes)
from test_read_10x_local import N_GENES, _make_matrix, _write_mtx_dir, \
    _write_v3_h5
from torch_port_threads import _one_thread  # noqa: F401

LOADERS = ("tenx", "pbmc8k", "pbmcecc", "citeseq", "facs", "scvi_datasets",
           "leukemia", "misc")


def _mods(pkg):
  return [importlib.import_module(f"{pkg}.data.loaders.{m}")
          for m in LOADERS]


@pytest.fixture(autouse=True)
def _offline(monkeypatch):
  """No network in any test here, and the npz files' zip timestamps
  frozen, so two caches of the same arrays are the same bytes."""
  def _refuse(url, *a, **k):
    raise OSError(f"network refused in tests: {url}")
  monkeypatch.setattr("urllib.request.urlretrieve", _refuse)
  monkeypatch.setattr(zipfile, "time", types.SimpleNamespace(
      time=lambda: 1_700_000_000.0, localtime=time.localtime))


def _point(monkeypatch, pkg, data, dl):
  for m in _mods(pkg):
    monkeypatch.setattr(m, "DATA_DIR", str(data))
    if hasattr(m, "DOWNLOAD_DIR"):
      monkeypatch.setattr(m, "DOWNLOAD_DIR", str(dl))


def _refuse_downloads(monkeypatch, pkg):
  def _miss(url, *a, **k):
    raise AssertionError(f"cache miss: download of {url}")
  for m in _mods(pkg):
    if hasattr(m, "download_file"):
      monkeypatch.setattr(m, "download_file", _miss)


def _same_matrix(a, b, what):
  assert sparse.issparse(a) == sparse.issparse(b), what
  assert a.dtype == b.dtype and a.shape == b.shape, what
  if sparse.issparse(a):
    a, b = a.tocsr(), b.tocsr()
    for f in ("indptr", "indices", "data"):
      np.testing.assert_array_equal(getattr(b, f), getattr(a, f),
                                    err_msg=f"{what}.{f}")
  else:
    np.testing.assert_array_equal(np.asarray(b), np.asarray(a),
                                  err_msg=what)


def _same_uns(j, t):
  assert set(t) == set(j)
  for k, v in j.items():
    if isinstance(v, (bool, int, float, str)):
      assert t[k] == v and type(t[k]) is type(v), k
    else:
      np.testing.assert_array_equal(np.asarray(t[k]), np.asarray(v),
                                    err_msg=k)


def _same(j, t):
  """The JAX container ``j`` and the port's ``t`` hold the same data."""
  assert t.name == j.name
  assert t.omics == list(j.omics)
  assert t.current_omic == j.current_omic.name
  np.testing.assert_array_equal(t.obs["cell_id"],
                                np.asarray(j.obs.index, str))
  np.testing.assert_array_equal(t.obs["indices"], j.obs["indices"].values)
  for o in j.omics:
    _same_matrix(j.get_omic(o), t.get_omic(o), o)
    assert list(t.get_var_names(o)) == [str(v) for v in j.get_var_names(o)]
    for k, v in j.stats(o).items():
      np.testing.assert_allclose(t.stats(o)[k], v, rtol=1e-6,
                                 err_msg=f"{o}_{k}")
  _same_uns(j.uns, t.uns)
  assert t.md5 == j.md5


def _caches(root):
  out = {}
  for dirpath, _, files in os.walk(root):
    if "manifest.json" in files:
      out[os.path.relpath(dirpath, root)] = dirpath
  return out


def _same_caches(jroot, troot):
  """Every cache folder the loads wrote, byte for byte, and each valid
  for the other package."""
  jc, tc = _caches(jroot), _caches(troot)
  assert set(tc) == set(jc) and jc
  for rel in jc:
    a, b = jc[rel], tc[rel]
    assert sorted(os.listdir(a)) == sorted(os.listdir(b)), rel
    for f in os.listdir(a):
      with open(os.path.join(a, f), "rb") as fa, \
          open(os.path.join(b, f), "rb") as fb:
        assert fa.read() == fb.read(), f"{rel}/{f}"
    assert TU.md5_folder(a) == JU.md5_folder(b) == JU.md5_folder(a)
    assert TU.validate_data_dir(a) and JU.validate_data_dir(b)


# ------------------------------------------------------- the raw trees
def _tenx_archive(path, X, genes, types_=None, legacy=False):
  """A 10x tar.gz of X (cells × features) with these feature names."""
  d = path.parent / (path.name + ".d") / "m"
  os.makedirs(d)
  sp_io.mmwrite(str(d / "matrix.mtx"), sparse.coo_matrix(X.T))
  with open(d / "barcodes.tsv", "w") as f:
    f.write("".join(f"AAAC{i:04d}-1\n" for i in range(X.shape[0])))
  with open(d / ("genes.tsv" if legacy else "features.tsv"), "w") as f:
    for j, g in enumerate(genes):
      kind = "" if legacy else "\t" + (types_[j] if types_ is not None
                                        else "Gene Expression")
      f.write(f"ENSG{j:05d}\t{g}{kind}\n")
  with tarfile.open(path, "w:gz") as t:
    t.add(d, arcname="filtered_gene_bc_matrices/hg19")


_PBMC_GENES = ["CD3D", "CD19", "LYZ", "CD14", "ACTB", "GAPDH", "CD4",
               "MS4A1", "NKG7", "ZERO1"]


def _pbmc_archive(path, seed, n_ly=8, n_my=5):
  """A 10x v2 run whose first n_ly cells are lymphoid, the rest myeloid,
  with marker genes of both and one gene never expressed."""
  rng = np.random.default_rng(seed)
  X = rng.poisson(1, (n_ly + n_my, len(_PBMC_GENES))).astype(np.float32)
  X[:n_ly, [0, 1, 7]] += 40.0
  X[n_ly:, [2, 3]] += 40.0
  X[:, -1] = 0.0
  _tenx_archive(path, X, _PBMC_GENES, legacy=True)


def _raw_tenx(dl, data):
  from sisua_tpu.data.loaders.tenx import TENX_CATALOG, _matrix_url
  tar, *_ = _make_10x_archive(dl.parent, True)
  for name in ("pbmc4k", "pbmc_10k_protein_v3"):
    url = _matrix_url(*TENX_CATALOG[name], filtered=True)
    shutil.copy(tar, dl / os.path.basename(url))


def _raw_cortex(dl, data):
  rng = np.random.default_rng(1)
  n_cells, n_genes = 25, 40
  labels = [("astro", "neuron", "oligo")[i % 3] for i in range(n_cells)]
  with open(dl / "cortex_expression_mRNA.txt", "w") as f:
    f.write("tissue\t\t" + "\t".join(["ctx"] * n_cells) + "\n")
    f.write("group #\t\t" + "\t".join(labels) + "\n")
    f.write("total mRNA mol\t\t" + "\t".join(["100"] * n_cells) + "\n")
    for g in range(n_genes):
      f.write(f"Gene{g}\t0\t" + "\t".join(
          map(str, rng.poisson(2, n_cells))) + "\n")


def _raw_citeseq(dl, data):
  """GEO's layout: genes × cells CSVs; 3 mouse-dominated cells, a cell at
  the 0.9 human threshold, an all-zero cell, a repeated cell name, silent
  genes, and the ADT table's cells in another order."""
  rng = np.random.default_rng(2)
  cells = [f"cell{i}" for i in range(20)] + ["cell3"]
  genes = ([f"HUMAN_G{i}" for i in range(25)]
           + ["MOUSE_Bad1", "MOUSE_Bad2"])
  rna = rng.poisson(2, (27, 21))
  rna[25:, :] = 0
  rna[:25, :3], rna[25:, :3] = 0, 50
  rna[:25, 4], rna[25, 4], rna[26, 4] = 0, 9, 1   # 90 of 100: dropped
  rna[0, 4] = 90
  rna[:, 5] = 0                                   # 0/0: dropped
  rna[20:25, :] = 0                               # silent genes
  rna[20, 6] = 1
  prots = ["CD4", "CD8a", "CD3-TotalSeqB", "CD4"]
  adt = rng.poisson(30, (4, 21))
  # the ADT header names the cells as pandas reads the RNA header
  read_as = cells[:20] + ["cell3.1"]
  order = rng.permutation(21)
  for which in ("cbmc", "pbmc"):
    pd.DataFrame(rna, index=genes, columns=cells).to_csv(
        dl / f"{which}_rna.csv.gz", compression="gzip")
    pd.DataFrame(adt[:, order], index=prots,
                 columns=[read_as[i] for i in order]).to_csv(
                     dl / f"{which}_adt.csv.gz", compression="gzip")


def _raw_embryos(dl, data):
  rng = np.random.default_rng(3)
  cells = [f"E{3 + i % 4}.{i % 3 + 1}.{i}" for i in range(30)] + ["E7.4.9"]
  genes = [f"G{i}" for i in range(40)]
  erccs = [f"ERCC-{i:05d}" for i in range(5)]
  d = dl / "human_embryos"
  os.makedirs(d)
  for k, (name, rows, scale) in enumerate(
      [("counts.txt", genes, 4.0), ("rpkm.txt", genes, 6.0),
       ("ercc.counts.txt", erccs, 4.0), ("ercc.rpkm.txt", erccs, 4.0)],
      start=1):
    text, _ = _gene_table(rng, cells, rows, scale=scale)
    with zipfile.ZipFile(d / f"E-MTAB-3929.processed.{k}.zip", "w") as z:
      z.writestr(name, text)


def _raw_centenarian(dl, data):
  rng = np.random.default_rng(4)
  cells = [f"BC{i:04d}" for i in range(25)]
  samples = [("SC1" if i % 3 else "CT1") for i in range(25)]
  d = dl / "SuperCentenarian_original"
  os.makedirs(d)
  with gzip.open(d / "01.UMI.txt.gz", "wt") as f:
    f.write("\t".join(cells) + "\n")
    for g in range(30):
      f.write(f"ENSG{g:05d}\t" + "\t".join(
          map(str, rng.poisson(2, len(cells)))) + "\n")
  with gzip.open(d / "03.Cell.Barcodes.txt.gz", "wt") as f:
    for c, s in zip(cells, samples):
      f.write(f"{c}\t{s}\t{s[:2]}\n")


def _raw_scale(dl, data):
  rng = np.random.default_rng(5)
  n_cells, n_peaks = 20, 50
  blobs = {
      "forebrain_x": sparse.csr_matrix(
          (rng.random((n_cells, n_peaks)) < 0.2).astype(np.float32)),
      "forebrain_cell": np.array([f"c{i}" for i in range(n_cells)]),
      "forebrain_peak": np.array([f"chr1:{i}-{i + 500}"
                                  for i in range(n_peaks)]),
      "forebrain_labels": np.array(["ex" if i % 2 else "inh"
                                    for i in range(n_cells)])}
  d = dl / "scale_dataset"
  os.makedirs(d)
  with zipfile.ZipFile(d / "scale_datasets.zip", "w") as z:
    for name, v in blobs.items():
      buf = io.BytesIO()
      if sparse.issparse(v):
        sparse.save_npz(buf, v)
      else:
        np.save(buf, v)
      z.writestr(f"scale_datasets/{name}", buf.getvalue())


def _raw_atlas(dl, data):
  """The metadata's labels as pandas types them: 'NA' and '' read as
  NaN in the cell labels, an integer tissue column, a float column."""
  rng = np.random.default_rng(6)
  n_cells, n_peaks = 15, 40
  d = dl / "mouse_atac"
  os.makedirs(d)
  with gzip.open(d / "atac_matrix.binary.qc_filtered.mtx.gz", "wb") as f:
    sp_io.mmwrite(f, sparse.coo_matrix(
        (rng.random((n_peaks, n_cells)) < 0.25).astype(np.float32)))
  (d / "atac_matrix.binary.qc_filtered.cells.txt").write_text(
      "\n".join(f"cell{i}" for i in range(n_cells)) + "\n")
  (d / "atac_matrix.binary.qc_filtered.peaks.txt").write_text(
      "\n".join(f"p{i}" for i in range(n_peaks)) + "\n")
  labels = ["T0", "T1", "NA", "", "T2", "10", "T1", "nan", "T0", "T2",
            "T1", "T0", "2.5", "T2", "T1"]
  with open(d / "cell_metadata.txt", "w") as f:
    f.write("cell\ttissue\tcell_label\tscore\n")
    for i in range(n_cells):
      f.write(f"cell{i}\t{1 + i % 2}\t{labels[i]}\t{i / 4}\n")


def _raw_facs2(dl, data):
  rng = np.random.default_rng(8)
  n_cells, n_genes = 18, 25
  X = rng.poisson(2, (n_cells, n_genes)).astype(np.float32)
  X[:, 3] = 0.0
  y = rng.poisson(40, (n_cells, 2)).astype(np.float32)
  buf = io.BytesIO()
  sparse.save_npz(buf, sparse.csr_matrix(X))
  rows = "\n".join(f"c{i}" for i in range(n_cells)).encode()
  members = [("X.npz", buf.getvalue()), ("X_row.csv", rows),
             ("X_col.csv", "\n".join(f"g{i}"
                                     for i in range(n_genes)).encode()),
             ("y.csv", "\n".join(",".join(map(str, r)) for r in y).encode()),
             ("y_row.csv", rows), ("y_col.csv", b"CD4\nCD8")]
  os.makedirs(dl / "FACS_original")
  _make_winzip_aes(str(dl / "FACS_original" / "KI_FACS_2protein.zip"),
                   members, "uef-czi")


def _raw_facs7(dl, data):
  rng = np.random.default_rng(9)
  genes = [f'"G{i}"' for i in range(20)]
  chans = ['"facs_cd34"', '"facs_cd38"', '"other"']

  def table(cells, cols):
    lines = ['"id",' + ",".join(cols)]
    for c in cells:
      lines.append(f'"{c}",' + ",".join(
          f"{v:.2f}" for v in rng.normal(100, 30, len(cols))))
    t = np.array([ln.split(",") for ln in lines]).T  # genes × cells
    return ("\n".join(",".join(r) for r in t) + "\n").encode()
  c1, c2 = [f"I1_c{i}" for i in range(10)], [f"I2_c{i}" for i in range(8)]
  files = {"raw_filtered_I1": table(c1, genes + ['"G_only1"']),
           "raw_filtered_I2": table(c2, genes),
           "facs_indeces_filtered_I1": table(c1[:9], chans),
           "facs_indeces_filtered_I2": table(c2, chans)}
  os.makedirs(dl / "FACS_full")
  for name, blob in files.items():
    with gzip.open(dl / "FACS_full" /
                   f"GSE75478_transcriptomics_{name}.csv.gz", "wb") as f:
      f.write(blob)


def _raw_pbmc_rebuild(dl, data):
  _pbmc_archive(dl / "pbmc8k_filtered_gene_bc_matrices.tar.gz", 0)
  _pbmc_archive(dl / "pbmc4k_filtered_gene_bc_matrices.tar.gz", 3, 6, 7)


def _raw_pbmc_adt(dl, data):
  _raw_pbmc_rebuild(dl, data)
  adt = np.arange(13 * 3, dtype=np.float32).reshape(13, 3)
  JU.save_to_dataset(str(data / "pbmc8k_adt"), adt,
                     ["CD3", "CD19p", "CD14p"], print_log=False)


def _raw_pbmc_author(dl, data):
  _, y, _, rows = _author_npz(str(dl / "pbmc8k_full.npz"), n=12, seed=2,
                              full=True)
  rng = np.random.default_rng(3)
  np.savez(str(dl / "pbmc8k_ly.npz"),
           X_filt=rng.poisson(1, (7, 2)).astype(np.float32),
           X_filt_col=np.array(["CD3D", "ACTB"]),
           X_full=rng.poisson(1, (7, 2)).astype(np.float32) + 1,
           X_full_col=np.array(["CD3D", "ACTB"]),
           X_row=rows[:7], y=y[:7], y_col=np.array(["CD3", "CD4", "CD8"]))
  _author_npz(str(dl / "pbmcecc_ly.npz"), n=6, seed=4)


def _raw_call(dl, data):
  rng = np.random.default_rng(7)
  genes1, genes2 = ["TP53", "MYC", "ACTB", "RARE1"], ["ACTB", "TP53",
                                                      "MYC", "NOVEL9"]
  X1 = rng.poisson(3, (4, 5)).astype(np.float32)
  X1[3] = 0.0
  X2 = rng.poisson(3, (4, 4)).astype(np.float32)
  with tarfile.open(dl / "GSE132509_RAW.tar", "w") as t:
    for s, genes, X in [("GSM1_ETV6-RUNX1_1", genes1, X1),
                        ("GSM2_HHD_1", genes2, X2),
                        ("GSM3_PBMMC_1", genes1, X1[:, :2])]:
      _add_bytes(t, f"{s}.matrix.mtx.gz", _mtx_gz_bytes(X))
      _add_bytes(t, f"{s}.genes.tsv.gz", _gz_bytes("".join(
          f"ENS{i}\t{g}\n" for i, g in enumerate(genes))))
      _add_bytes(t, f"{s}.barcodes.tsv.gz", _gz_bytes("".join(
          f"BC{i}\n" for i in range(X.shape[1]))))


def _raw_placed_caches(dl, data):
  """Caches converted beforehand (MPAL's R objects, an scvi-tools
  dataset), placed under the data folder."""
  rng = np.random.default_rng(11)
  X = rng.poisson(2, (12, 20)).astype(np.float32)
  JU.save_to_dataset(str(data / "mpal_rna_preprocessed"), X,
                     [f"g{i}" for i in range(20)],
                     y=rng.poisson(9, (12, 4)).astype(np.float32),
                     y_col=["CD3", "CD4", "CD8", "CD19"], print_log=False)
  JU.save_to_dataset(str(data / "pbmcscvi_preprocessed"),
                     sparse.csr_matrix(X), [f"g{i}" for i in range(20)],
                     y=np.eye(3, dtype=np.float32)[np.arange(12) % 3],
                     y_col=["B", "NK", "T"], print_log=False)


# family → (what writes its raw tree, [(registry name, kwargs)])
FAMILIES = {
    "tenx": (_raw_tenx, [("4k", {}), ("pbmc4kall", {}), ("10k", {})]),
    "cortex": (_raw_cortex, [("cortex", {"n_top_genes": 30}),
                             ("cortex", {})]),
    "citeseq": (_raw_citeseq, [("cbmcciteseqall", {}),
                               ("pbmcciteseq", {})]),
    "embryos": (_raw_embryos, [("embryos", {}), ("embryosall", {})]),
    "centenarian": (_raw_centenarian, [("centenarian", {})]),
    "scale": (_raw_scale, [("scaleforebrain", {})]),
    "mouseatlas": (_raw_atlas, [("mouseatlas", {})]),
    "facs2": (_raw_facs2, [("facs2", {})]),
    "facs7": (_raw_facs7, [("facs7", {}), ("facs", {})]),
    "pbmc_rebuild": (_raw_pbmc_rebuild, [("8kly", {}), ("8kmy", {}),
                                         ("8k", {}), ("8kall", {}),
                                         ("eccly", {}), ("ecc", {})]),
    "pbmc_adt": (_raw_pbmc_adt, [("8k", {})]),
    "pbmc_author": (_raw_pbmc_author, [("8k", {}), ("8kly", {}),
                                       ("eccly", {})]),
    "call": (_raw_call, [("call", {}), ("callall", {})]),
    "placed": (_raw_placed_caches, [("mpal", {}), ("pbmcscvi", {})]),
    "cross": (_raw_pbmc_rebuild, [("8kx", {}), ("eccx", {}),
                                  ("8kxnoprot", {})]),
}
CASES = [(fam, name, kw) for fam, (_, names) in FAMILIES.items()
         for name, kw in names]


@pytest.mark.parametrize(
    "family, name, kw", CASES,
    ids=[f"{f}-{n}{'-' + '-'.join(map(str, kw.values())) if kw else ''}"
         for f, n, kw in CASES])
def test_loader_equals_jax_and_caches_swap(family, name, kw, tmp_path,
                                           monkeypatch):
  raw_dl, raw_data = tmp_path / "raw" / "dl", tmp_path / "raw" / "data"
  os.makedirs(raw_dl)
  os.makedirs(raw_data)
  FAMILIES[family][0](raw_dl, raw_data)
  dirs = {}
  for side in ("jax", "port"):
    dirs[side] = (tmp_path / side / "data", tmp_path / side / "dl")
    shutil.copytree(raw_data, dirs[side][0])
    shutil.copytree(raw_dl, dirs[side][1])
  _point(monkeypatch, "sisua_tpu", *dirs["jax"])
  _point(monkeypatch, "sisua_tpu_torch", *dirs["port"])
  j = JD.get_dataset(name, **kw)
  t = TD.get_dataset(name, **kw)
  _same(j, t)
  if _caches(dirs["jax"][0]):
    _same_caches(dirs["jax"][0], dirs["port"][0])
  # each package on the other's data folder, downloads refused
  empty = tmp_path / "empty"
  os.makedirs(empty)
  _refuse_downloads(monkeypatch, "sisua_tpu")
  _refuse_downloads(monkeypatch, "sisua_tpu_torch")
  _point(monkeypatch, "sisua_tpu", dirs["port"][0], empty)
  _point(monkeypatch, "sisua_tpu_torch", dirs["jax"][0], empty)
  _same(j, TD.get_dataset(name, **kw))
  _same(JD.get_dataset(name, **kw), t)


def test_finalize_cache_and_cistopic_equal_jax(tmp_path, monkeypatch):
  """tools/convert_rds.R's output (mtx + txt) through each package's
  finalize_cache: the same cache bytes, and the R-gated cisTopic loader
  reads it; without it both loaders raise the same error."""
  from sisua_tpu.data.loaders.finalize_cache import finalize as jfin
  from sisua_tpu_torch.data.loaders.finalize_cache import finalize as tfin
  rng = np.random.default_rng(7)
  src = tmp_path / "converted"
  os.makedirs(src)
  sp_io.mmwrite(str(src / "X.mtx"), sparse.coo_matrix(
      rng.poisson(0.5, (12, 20)).astype(np.float32)))
  (src / "X_col.txt").write_text("\n".join(f"pk{i}" for i in range(20)))
  (src / "X_row.txt").write_text("\n".join(f"c{i}" for i in range(12)))
  sp_io.mmwrite(str(src / "y.mtx"),
                sparse.coo_matrix(np.eye(2)[np.arange(12) % 2]))
  (src / "y_col.txt").write_text("mel\nimmune\n")
  for side in ("jax", "port"):
    _point(monkeypatch, "sisua_tpu" if side == "jax" else "sisua_tpu_torch",
           tmp_path / side, tmp_path / side / "dl")
  with pytest.raises(RuntimeError) as je:
    JD.get_dataset("melanomaatac")
  with pytest.raises(RuntimeError) as te:
    TD.get_dataset("melanomaatac")
  assert str(te.value).replace(str(tmp_path / "port"), "D") == \
      str(je.value).replace(str(tmp_path / "jax"), "D")
  jfin(str(src), str(tmp_path / "jax" / "melanoma_atac_preprocessed"))
  tfin(str(src), str(tmp_path / "port" / "melanoma_atac_preprocessed"))
  _same_caches(tmp_path / "jax", tmp_path / "port")
  _same(JD.get_dataset("melanomaatac"), TD.get_dataset("melanomaatac"))


@pytest.mark.parametrize("name, error", [
    ("mpal", "convert_rds"), ("mpalatac", "convert_rds"),
    ("retina", "scvi-tools"), ("hemato", "scvi-tools")])
def test_gated_loaders_raise_as_jax(name, error, tmp_path, monkeypatch):
  """Without its converted cache, or scvi-tools, a gated name raises the
  JAX loader's RuntimeError."""
  _point(monkeypatch, "sisua_tpu", tmp_path, tmp_path)
  _point(monkeypatch, "sisua_tpu_torch", tmp_path, tmp_path)
  monkeypatch.setitem(__import__("sys").modules, "scvi", None)
  errs = []
  for D in (JD, TD):
    with pytest.raises(RuntimeError, match=error) as e:
      D.get_dataset(name)
    errs.append(str(e.value))
  assert errs[0] == errs[1]


# ----------------------------------------------------------- the helpers
@pytest.mark.parametrize("case", ["offline", "md5_mismatch", "placed",
                                  "placed_stale_md5"])
def test_download_file_as_jax(case, tmp_path, monkeypatch):
  out = str(tmp_path / "sub" / "f.bin")
  md5 = None
  if case == "md5_mismatch":
    md5 = "0" * 32
  if case.startswith("placed"):
    os.makedirs(tmp_path / "sub")
    with open(out, "wb") as f:
      f.write(b"placed")
  if case == "placed_stale_md5":
    md5 = "202cb962ac59075b964b07152d234b70"  # md5 of b"123"
  if case != "offline":
    def fetch(url, path):
      with open(path, "wb") as f:
        f.write(b"123")
    monkeypatch.setattr("urllib.request.urlretrieve", fetch)
  results = []
  for U in (JU, TU):
    if case.startswith("placed"):
      with open(out, "wb") as f:
        f.write(b"placed")
    try:
      results.append(("ok", U.download_file("http://h/f.bin", out, md5=md5),
                      open(out, "rb").read()))
    except RuntimeError as e:
      results.append(("raised", str(e), type(e.__cause__).__name__))
  assert results[0] == results[1]
  want = {"offline": "raised", "md5_mismatch": "raised", "placed": "ok",
          "placed_stale_md5": "ok"}[case]
  assert results[1][0] == want
  if case == "placed":
    assert results[1][2] == b"placed"
  if case == "placed_stale_md5":
    assert results[1][2] == b"123"


def test_archives_and_aes_as_jax(tmp_path, monkeypatch):
  """read_compressed (tar.gz, zip, gz), the WinZip-AES reader with a wrong
  password, md5_checksum, remove_allzeros_columns, the dtype helpers and
  validating_dataset, against the JAX functions."""
  inner = tmp_path / "payload.txt"
  inner.write_text("hello")
  with tarfile.open(tmp_path / "a.tar.gz", "w:gz") as t:
    t.add(inner, arcname="payload.txt")
  with zipfile.ZipFile(tmp_path / "b.zip", "w") as z:
    z.writestr("d/c.txt", "zip")
  with gzip.open(tmp_path / "e.txt.gz", "wt") as f:
    f.write("world")
  for arc in ("a.tar.gz", "b.zip", "e.txt.gz"):
    j = JU.read_compressed(str(tmp_path / arc), str(tmp_path / "j"))
    t = TU.read_compressed(str(tmp_path / arc), str(tmp_path / "t"))
    assert [os.path.relpath(p, tmp_path / "t") for p in t] == \
        [os.path.relpath(p, tmp_path / "j") for p in j]
    for a, b in zip(j, t):
      if os.path.isfile(a):
        assert open(a).read() == open(b).read()
  with pytest.raises(ValueError, match="Unsupported"):
    TU.read_compressed(str(inner), str(tmp_path / "x"))
  members = [("a.txt", b"alpha" * 50), ("b.bin", bytes(range(200)))]
  _make_winzip_aes(str(tmp_path / "s.zip"), members, "pw")
  assert list(TU.unzip_aes(str(tmp_path / "s.zip"), "pw")) == \
      list(JU.unzip_aes(str(tmp_path / "s.zip"), "pw")) == members
  with pytest.raises(RuntimeError, match="Bad password"):
    list(TU.unzip_aes(str(tmp_path / "s.zip"), "nope"))
  assert TU.md5_checksum(str(inner)) == JU.md5_checksum(str(inner))
  rng = np.random.default_rng(0)
  m = rng.poisson(0.3, (20, 12)).astype(np.float32)
  m[:, 4] = 0
  m[:, 7] = 0
  m[3, 7] = 1.0
  for x in (m, sparse.csr_matrix(m)):
    (tm, tc), (jm, jc) = (U.remove_allzeros_columns(
        x, [f"g{i}" for i in range(12)], print_log=False) for U in (TU, JU))
    _same_matrix(jm, tm, "matrix")
    np.testing.assert_array_equal(tc, jc)
    for fn in ("is_binary_dtype", "is_categorical_dtype"):
      assert getattr(TU, fn)(x) == getattr(JU, fn)(x)
  onehot = np.eye(3, dtype=np.float32)[np.arange(9) % 3]
  assert TU.is_categorical_dtype(onehot) and TU.is_binary_dtype(onehot)
  TU.save_to_dataset(str(tmp_path / "ds"), sparse.csr_matrix(m),
                     [f"g{i}" for i in range(12)], y=rng.random((20, 2)),
                     y_col=["a", "b"], print_log=False)
  TU.validating_dataset(str(tmp_path / "ds"))
  JU.validating_dataset(str(tmp_path / "ds"))
  with pytest.raises(AssertionError, match="X_col"):
    TU.validating_dataset({"X": m, "X_col": ["a"], "X_row": ["r"] * 20})
  monkeypatch.setitem(__import__("sys").modules, "rpy2", None)
  with pytest.raises(RuntimeError, match="rpy2"):
    TU.read_r_matrix(str(tmp_path / "x.rds"))


def test_gene_id2name_as_jax(tmp_path, monkeypatch):
  d = tmp_path / "dl" / "10x_x" / "m"
  os.makedirs(d)
  with gzip.open(d / "features.tsv.gz", "wt") as f:
    f.write("ENSG1\tCD3D\tGene Expression\nENSG2\tLYZ\tGene Expression\n")
  (d / "genes.tsv").write_text("ENSG3\tACTB\nENSG4\tOTHER\n")
  out = []
  for pkg in ("sisua_tpu", "sisua_tpu_torch"):
    side = tmp_path / pkg
    shutil.copytree(tmp_path / "dl", side)
    monkeypatch.setattr(f"{pkg}.data.path.DOWNLOAD_DIR", str(side))
    U = importlib.import_module(f"{pkg}.data.utils")
    out.append(U.get_gene_id2name())
    assert os.path.isfile(side / "gene_id2name.pkl")
    assert U.get_gene_id2name() == out[-1]
  assert out[0] == out[1] and out[1]["ENSG3"] == "ACTB"
  monkeypatch.setattr("sisua_tpu_torch.data.path.DOWNLOAD_DIR",
                      str(tmp_path / "none"))
  os.makedirs(tmp_path / "none")
  with pytest.raises(RuntimeError, match="gene id"):
    TU.get_gene_id2name(cache_only=True)


def test_csv_table_reads_as_pandas(tmp_path):
  """Values, index and header as ``pd.read_csv(index_col=0)``: int and
  float columns, pandas' NA strings, quoted fields, repeated header
  names."""
  text = ('id,a,b,a,"c,d",e\n'
          'r1,1,2.5,NA,,7\n'
          '"r,2",3,nan,4,5,-1e-3\n'
          'r3,0,N/A,6,1e20,null\n')
  p = tmp_path / "t.csv"
  p.write_text(text)
  v, idx, cols = TU.read_csv_table(str(p))
  df = pd.read_csv(p, index_col=0)
  np.testing.assert_array_equal(v, df.to_numpy(np.float64))
  assert list(idx) == list(df.index) and list(cols) == list(df.columns)
  np.testing.assert_array_equal(TU.read_csv_matrix(str(p)),
                                df.to_numpy(np.float32))


# ------------------------------------------------------------ the readers
_MTX_CASES = {"features": dict(), "gz_legacy": dict(gz=True,
                                                    legacy_genes=True),
              "peaks": dict(peaks=True), "gz_peaks": dict(gz=True,
                                                          peaks=True)}


@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("case", list(_MTX_CASES))
def test_read_10x_mtx_as_jax(case, filtered, tmp_path):
  X = _make_matrix(1)
  X[:, 2] = 0.0
  d = str(tmp_path / "dir")
  _write_mtx_dir(d, X, **_MTX_CASES[case])
  _same(JD.read_10x_mtx(d, filtered_genes=filtered),
        TD.read_10x_mtx(d, filtered_genes=filtered))
  _same(JD.get_dataset(d), TD.get_dataset(d))


def _write_v2_h5(path, X):
  import h5py
  C = sparse.csc_matrix(X.T)
  with h5py.File(path, "w") as f:
    g = f.create_group("GRCh38")
    for k in ("data", "indices", "indptr"):
      g.create_dataset(k, data=getattr(C, k))
    g.create_dataset("shape", data=np.asarray(C.shape, np.int64))
    g.create_dataset("barcodes", data=np.asarray(
        [f"C{i}".encode() for i in range(X.shape[0])]))
    g.create_dataset("gene_names", data=np.asarray(
        [f"G{j % 7}".encode() for j in range(X.shape[1])]))


@pytest.mark.parametrize("layout", ["v3", "v2"])
def test_read_10x_h5_as_jax(layout, tmp_path):
  """v3 (ADT split) and v2 (one genome group, repeated gene names: the
  container suffixes them as the JAX one does)."""
  X = _make_matrix(3)
  h5 = str(tmp_path / f"{layout}.h5")
  (_write_v3_h5 if layout == "v3" else _write_v2_h5)(h5, X)
  _same(JD.read_10x_h5(h5), TD.read_10x_h5(h5))
  _same(JD.read_10x_h5(h5, name="x", filtered_genes=True),
        TD.read_10x_h5(h5, name="x", filtered_genes=True))
  _same(JD.get_dataset(h5), TD.get_dataset(h5))
  if layout == "v3":
    assert TD.get_dataset(h5).get_dim("transcriptomic") == N_GENES


def test_h5py_readers_name_h5py_without_it(tmp_path, monkeypatch):
  h5 = tmp_path / "m.h5"
  h5.write_bytes(b"")
  ad = tmp_path / "m.h5ad"
  ad.write_bytes(b"")
  monkeypatch.setitem(__import__("sys").modules, "h5py", None)
  for call in (lambda: TD.get_dataset(str(h5)),
               lambda: TD.get_dataset(str(ad)),
               lambda: TD.write_h5ad(TD.generate_synthetic(20, 8, 2),
                                     str(ad))):
    with pytest.raises(ImportError, match="h5py"):
      call()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_h5ad_across_packages(writer, tmp_path):
  """A container written by one package's ``write_h5ad`` reads back in
  both as the same container: omics in order, var names, the obs
  columns (the file's own under 'file_' where they meet the
  container's), uns."""
  kw = dict(n_cells=150, n_genes=25, n_proteins=4, n_celltypes=3, seed=2)
  src = (JD if writer == "jax" else TD).generate_synthetic(**kw)
  path = str(tmp_path / "rt.h5ad")
  (JD if writer == "jax" else TD).write_h5ad(src, path)
  j, t = JD.read_h5ad(path), TD.read_h5ad(path)
  _same(j, t)
  for col in j.obs.columns:
    np.testing.assert_array_equal(t.obs[col], j.obs[col].to_numpy(),
                                  err_msg=col)
  assert set(t.obs) == set(j.obs.columns) | {"cell_id"}
  _same(j, TD.get_dataset(path))
  assert t.omics == list(src.omics)


def test_h5ad_foreign_file_as_jax(tmp_path):
  """A scvi-tools style file: CSR X, categorical obs, protein obsm, an
  obs column named 'indices', an unknown obsm key."""
  import h5py
  path = str(tmp_path / "foreign.h5ad")
  rng = np.random.default_rng(0)
  X = sparse.random(60, 20, density=0.3, format="csr", random_state=0,
                    dtype=np.float32)
  with h5py.File(path, "w") as f:
    g = f.create_group("X")
    g.attrs["encoding-type"] = "csr_matrix"
    g.attrs["shape"] = np.asarray(X.shape, np.int64)
    for k in ("data", "indices", "indptr"):
      g.create_dataset(k, data=getattr(X, k))
    obs = f.create_group("obs")
    obs.attrs["_index"] = "_index"
    obs.create_dataset("_index", data=np.asarray(
        [f"c{i}" for i in range(60)], dtype="S"))
    obs.create_dataset("indices", data=np.arange(100, 160))
    cat = obs.create_group("batch")
    cat.create_dataset("categories", data=np.asarray(["b0", "b1"],
                                                     dtype="S"))
    cat.create_dataset("codes", data=rng.integers(-1, 2, 60))
    var = f.create_group("var")
    var.attrs["_index"] = "_index"
    var.create_dataset("_index", data=np.asarray(
        [f"g{i}" for i in range(20)], dtype="S"))
    obsm = f.create_group("obsm")
    obsm.create_dataset("protein_expression",
                        data=rng.poisson(5, (60, 3)).astype(np.float32))
    obsm.create_dataset("X_umap", data=rng.normal(size=(60, 2)))
    f.create_group("uns").create_dataset("note", data=np.asarray(b"hi"))
  j, t = JD.read_h5ad(path), TD.read_h5ad(path)
  _same(j, t)
  for col in ("file_indices", "batch"):
    np.testing.assert_array_equal(t.obs[col], j.obs[col].to_numpy())
  np.testing.assert_array_equal(t.obsm["X_umap"], j.obsm["X_umap"])


# ------------------------------------------------------- OMIC, registry
def test_omic_algebra_as_jax():
  from sisua_tpu.data.const import OMIC as J
  from sisua_tpu_torch.data.const import OMIC as T
  names = ["transcriptomic", "proteomic", "celltype", "iproteomic", "atac",
           "latent", "proteomic_transcriptomic", "Transcriptomic_ATAC"]
  for a in names:
    ja, ta = J.parse(a), T.parse(a)
    assert (ta.name, str(ta), repr(ta), len(ta)) == \
        (ja.name, str(ja), repr(ja), len(ja))
    assert [o.name for o in ta] == [o.name for o in ja]
    assert (ta.is_imputed, ta.markers) == (ja.is_imputed, ja.markers)
    assert ta == ja.name and hash(ta) == hash(T.parse(ja.name))
    for b in names:
      jb, tb = J.parse(b), T.parse(b)
      assert (ta | tb).name == (ja | jb).name
      assert (ta & b).name == (ja & b).name
      assert (tb in ta) == (jb in ja)
      assert (ta < tb) == (ja < jb) and (ta == tb) == (ja == jb)
      assert ta.marker_pairs(b) == ja.marker_pairs(b)
  assert sorted(T.parse(n) for n in names) == sorted(
      T.parse(J.parse(n).name) for n in names)
  assert [T.is_omic_type(x) for x in ("rna", "atac", "tissue_x")] == \
      [J.is_omic_type(x) for x in ("rna", "atac", "tissue_x")]
  with pytest.raises(ValueError, match="Unknown OMIC"):
    T.parse("rna")
  assert (T.transcriptomic == None) is False  # noqa: E711
  import sisua_tpu_torch
  assert sisua_tpu_torch.OMIC is T
  sco = TD.generate_synthetic(n_cells=30, n_genes=8, n_proteins=2)
  assert TD.get_all_omics(sco) == [T.parse(o) for o in sco.omics]
  assert sco.numpy(T.proteomic).shape == (30, 2)
  feeder = sco.create_dataset(T.transcriptomic | T.proteomic, batch_size=8)
  assert len(feeder.sources) == 2


def test_registry_names_loaders_and_availability_as_jax():
  jm, tm = JD.get_dataset_meta(), TD.get_dataset_meta()
  assert list(tm) == list(jm)
  for name, jf in jm.items():
    tf = tm[name]
    jfn, tfn = (getattr(f, "func", f) for f in (jf, tf))
    assert tfn.__name__ == jfn.__name__, name
    assert getattr(tf, "args", ()) == getattr(jf, "args", ()), name
    assert getattr(tf, "keywords", {}) == getattr(jf, "keywords", {}), name
  assert TD.get_dataset_availability() == JD.get_dataset_availability()
  assert TD.AVAILABILITY == JD.AVAILABILITY
  for name in ("synthetic1k", "mpal", "retina", "facs2", "Cortex "):
    assert TD.get_dataset_availability(name) == \
        JD.get_dataset_availability(name)
  with pytest.raises(KeyError):
    TD.get_dataset_availability("nope")
  with pytest.raises(KeyError, match="Did you mean"):
    TD.get_dataset("8klyy")


def test_dataset_summary_rows_as_jax(tmp_path, monkeypatch):
  """The rows on a few small names, one of them without its files (an
  error row), against the JAX DataFrame's records."""
  for pkg in ("sisua_tpu", "sisua_tpu_torch"):
    _point(monkeypatch, pkg, tmp_path, tmp_path)
  names = ["synthetic200", "synthetic500", "cortex", "not_a_name"]
  jdf = JD.get_dataset_summary(names=names)
  rows = TD.get_dataset_summary(names=names)
  want = [{k: v for k, v in r.items() if not (isinstance(v, float)
                                              and np.isnan(v))}
          for r in jdf.to_dict("records")]
  assert rows == want
  html = TD.get_dataset_summary(return_html=True, names=names[:2])
  assert html.startswith("<table") and "synthetic500" in html
  assert html.count("<tr>") == 3


def test_showdata_list_as_jax(capsys):
  """``sisua-showdata --list``: every name with its availability tag and
  the closing line, as the JAX command prints them."""
  from sisua_tpu.cli.showdata import main as jshow
  from sisua_tpu_torch.cli.showdata import main as tshow
  assert jshow(["--list"]) is None
  jout = capsys.readouterr().out
  assert tshow(["--list"]) is None
  tout = capsys.readouterr().out
  assert tout == jout and "R-required" in tout and "synthetic1m" in tout


@pytest.mark.parametrize("fn", ["sisua_to_anndata", "sisua_to_scvi"])
def test_scvi_export_raises_as_jax_without_its_packages(fn, monkeypatch):
  """Without anndata or scvi-tools the export raises the JAX function's
  RuntimeError, before any work."""
  import sys
  import sisua_tpu.data.sisua_to_scvi as JS
  import sisua_tpu_torch.data.sisua_to_scvi as TS
  for name in ("anndata", "scvi"):
    monkeypatch.setitem(sys.modules, name, None)
  errs = []
  for mod, D in ((JS, JD), (TS, TD)):
    sco = D.generate_synthetic(n_cells=20, n_genes=6, n_proteins=2)
    with pytest.raises(RuntimeError) as e:
      getattr(mod, fn)(sco)
    errs.append(str(e.value))
  assert errs[0] == errs[1]
