"""sisua_tpu_torch.data — the data layer, without pandas (counterpart of
``sisua_tpu.data``): the feeder, the library statistics and corruption,
the port's ``SingleCellOMIC`` (``dataset.py``) with the JAX analyzer
(``analysis.py``: QC, filters, PCA/UMAP, neighbours, clusterings, rank
tests, correlations, mutual information and importances, on the card),
the ``OMIC`` flag and the marker tables, the numpy synthetic generators,
the dataset loaders (``loaders/``), the 10x and AnnData readers, and
``get_dataset`` over the JAX registry.

``get_dataset(name)`` resolves a registry alias to its loader; the
'…all' suffix loads the unfiltered-genes variant. The synthetic family
('synthetic', 'synthetic<k>', 'citeseqsim') is made in memory. Every
other name reads its cache under DATA_DIR ($SISUA_DATA), or parses the
raw files found under DOWNLOAD_DIR ($SISUA_DOWNLOAD) and writes that
cache; only a missing raw file is downloaded. A cache either package
writes is a cache hit for the other. A user's own data loads directly:
a CellRanger matrix directory (``matrix.mtx[.gz]``) through
``read_10x_mtx``, a CellRanger ``.h5`` through ``read_10x_h5`` and a
``.h5ad`` through ``read_h5ad`` (both need h5py, imported there).
``get_dataset_availability`` tags each name: 'always' (made in memory),
'public-download' (the loader's own download and preprocess),
'optional-dep' (needs scvi-tools) or 'R-required' (upstream .rds,
converted with ``tools/convert_rds.R``).
"""

from __future__ import annotations

import difflib
import html
import inspect
import os
from functools import partial
from typing import Callable, Dict

from .const import (MARKER_ADT_GENE, MARKER_ADTS, MARKER_ATAC, MARKER_GENES,
                    OMIC, PROTEIN_PAIR_NEGATIVE, PROTEIN_PAIR_POSITIVE,
                    TSNE_DIM, UNIVERSAL_RANDOM_SEED, get_all_omics,
                    marker_pairs)
from .dataset import SingleCellOMIC
from .feeder import DataFeeder
from .h5ad import read_h5ad, write_h5ad
from .loaders.tenx import read_10x_h5, read_10x_mtx
from .path import CONFIG_PATH, DATA_DIR, DOWNLOAD_DIR, EXP_DIR
from .synthetic import (SYNTHETIC_SIZES, generate_citeseq, generate_multiome,
                        generate_synthetic, read_synthetic)
from .utils import (apply_artificial_corruption, get_library_size,
                    int16_exact, standardize_protein_name)

__all__ = ["DataFeeder", "SingleCellOMIC", "OMIC", "get_dataset",
           "get_dataset_meta", "get_dataset_availability",
           "get_dataset_summary", "AVAILABILITY", "generate_synthetic",
           "generate_citeseq", "generate_multiome", "read_synthetic",
           "SYNTHETIC_SIZES", "read_h5ad", "write_h5ad", "read_10x_mtx",
           "read_10x_h5", "get_library_size", "int16_exact",
           "apply_artificial_corruption", "standardize_protein_name",
           "get_all_omics", "MARKER_ADT_GENE", "MARKER_ADTS", "MARKER_ATAC",
           "MARKER_GENES", "PROTEIN_PAIR_NEGATIVE", "PROTEIN_PAIR_POSITIVE",
           "TSNE_DIM", "marker_pairs", "UNIVERSAL_RANDOM_SEED", "DATA_DIR",
           "DOWNLOAD_DIR", "EXP_DIR", "CONFIG_PATH"]

# the availability tags of the registry's names
AVAILABILITY = ("always", "public-download", "optional-dep", "R-required")

_META_CACHE: Dict[str, Callable] = {}
_AVAILABILITY_CACHE: Dict[str, str] = {}


def _registry() -> Dict[str, Callable]:
  from . import loaders as L
  from .loaders.tenx import TENX_CATALOG
  meta: Dict[str, Callable] = {}
  avail = _AVAILABILITY_CACHE
  avail.clear()

  # --- synthetic family (made in memory; the scalability sizes) -----------
  meta["synthetic"] = read_synthetic
  for k in SYNTHETIC_SIZES:
    meta[f"synthetic{k}"] = partial(read_synthetic, k)
  meta["citeseqsim"] = generate_citeseq
  avail.update({k: "always" for k in meta})

  # --- scVI benchmark sets -------------------------------------------------
  meta["cortex"] = L.read_Cortex
  meta["pbmcscvi"] = L.read_PBMC
  meta["retina"] = L.read_Retina
  meta["hemato"] = L.read_Hemato
  avail.update(cortex="public-download", pbmcscvi="optional-dep",
               retina="optional-dep", hemato="optional-dep")

  # --- PBMC 8k / ECC subsets (suffix '' = full panel) ----------------------
  for subset, suffix in (("ly", "ly"), ("my", "my"), ("full", "")):
    meta[f"8k{suffix}"] = partial(L.read_PBMC8k, subset)
    meta[f"ecc{suffix}"] = partial(L.read_PBMCeec, subset)
    meta[f"8k{suffix}all"] = partial(L.read_PBMC8k, subset,
                                     filtered_genes=False)
    meta[f"ecc{suffix}all"] = partial(L.read_PBMCeec, subset,
                                      filtered_genes=False)

  # --- CITE-seq -------------------------------------------------------------
  meta["pbmcciteseq"] = L.read_CITEseq_PBMC
  meta["cbmcciteseq"] = L.read_CITEseq_CBMC
  meta["pbmcciteseqall"] = partial(L.read_CITEseq_PBMC, filtered_genes=False)
  meta["cbmcciteseqall"] = partial(L.read_CITEseq_CBMC, filtered_genes=False)

  # --- FACS -------------------------------------------------------------
  for k in (2, 5, 7):
    meta[f"facs{k}"] = partial(L.read_FACS, k)
  meta["facs"] = L.read_full_FACS

  # --- leukemia ------------------------------------------------------------
  meta["mpal"] = partial(L.read_leukemia_MixedPhenotypes, omic="rna")
  meta["mpalatac"] = partial(L.read_leukemia_MixedPhenotypes, omic="atac")
  meta["mpalall"] = partial(L.read_leukemia_MixedPhenotypes, omic="rna",
                            filtered_genes=False)
  meta["call"] = L.read_leukemia_BMMC
  meta["callall"] = partial(L.read_leukemia_BMMC, filtered_genes=False)

  # --- misc -------------------------------------------------------------
  meta["embryos"] = L.read_human_embryos
  meta["embryosall"] = partial(L.read_human_embryos, filtered_genes=False)
  meta["centenarian"] = L.read_centenarian
  meta["melanomaatac"] = L.read_melanoma_cisTopicData
  meta["mouseatlas"] = L.read_mouse_ATLAS
  for scale_name in ("forebrain", "splenocyte", "leukemia", "insilico"):
    meta[f"scale{scale_name}"] = partial(L.read_scale_dataset, scale_name)

  # --- 10x catalog ----------------------------------------------------------
  for cat in TENX_CATALOG:
    meta[cat] = partial(L.read_dataset10x, cat)
    meta[f"{cat}all"] = partial(L.read_dataset10x, cat, filtered_genes=False)
  meta["4k"] = partial(L.read_dataset10x, "pbmc4k")
  meta["5k"] = partial(L.read_dataset10x, "5k_pbmc_protein_v3")
  meta["10k"] = partial(L.read_dataset10x, "pbmc_10k_protein_v3")
  meta["18k"] = partial(L.read_dataset10x, "18k")
  meta["neuron10k"] = partial(L.read_dataset10x, "neuron_10k_v3")
  meta["heart10k"] = partial(L.read_dataset10x, "heart_10k_v3")
  for i in (1, 2, 3, 4):
    meta[f"vdj{i}"] = partial(L.read_dataset10x,
                              f"vdj_v1_hs_aggregated_donor{i}")

  # --- cross-dataset ---------------------------------------------------------
  for c in ("8k", "ecc", "vdj1", "vdj4", "mpal", "call", "pbmc", "cbmc"):
    meta[f"{c}x"] = partial(L.read_PBMC_crossdataset, c)
  meta["8kxnoprot"] = partial(L.read_PBMC_crossdataset_remove_protein, "8k")

  # the rest have their own download and preprocess; the R-gated names are
  # those whose upstream ships .rds objects
  for name in meta:
    avail.setdefault(name, "public-download")
  for name in ("mpal", "mpalatac", "mpalall", "melanomaatac", "mpalx"):
    avail[name] = "R-required"
  return meta


def get_dataset_meta() -> Dict[str, Callable]:
  """Name → loader of the registry."""
  global _META_CACHE
  if not _META_CACHE:
    _META_CACHE = _registry()
  return _META_CACHE


def get_dataset_availability(name: str = None):
  """The availability tag of one registry name, or the name → tag map
  (tags in ``AVAILABILITY``; see the module docstring)."""
  get_dataset_meta()
  if name is None:
    return dict(_AVAILABILITY_CACHE)
  key = str(name).lower().strip()
  if key not in _AVAILABILITY_CACHE:
    raise KeyError(f"Unknown dataset '{name}'")
  return _AVAILABILITY_CACHE[key]


def _html_table(rows) -> str:
  """``pandas.DataFrame(rows).to_html()``'s table: the columns in order of
  first appearance, the row number as the index, NaN where a row lacks a
  column."""
  cols = list({k: None for r in rows for k in r})
  head = "".join(f"<th>{html.escape(str(c))}</th>" for c in cols)
  body = "".join(
      f"<tr><th>{i}</th>" + "".join(
          f"<td>{html.escape(str(r[c])) if c in r else 'NaN'}</td>"
          for c in cols) + "</tr>\n" for i, r in enumerate(rows))
  return (f'<table border="1" class="dataframe">\n<thead><tr><th></th>'
          f"{head}</tr></thead>\n<tbody>\n{body}</tbody>\n</table>")


def get_dataset_summary(return_html: bool = False, names=None,
                        availability=("always",)):
  """A table of the datasets' shapes and labels: one dict per name (the
  rows of the JAX function's DataFrame), or its HTML with
  ``return_html``. Only the names whose availability is in
  ``availability`` (default: the synthetic family) are loaded, or those
  in ``names``; ``availability=None`` takes every name. A name that fails
  to load gives a row with its error's type."""
  meta = get_dataset_meta()
  if names is None:
    names = [n for n, tag in get_dataset_availability().items()
             if availability is None or tag in availability]
  rows = []
  for name in sorted(str(n).lower().strip() for n in names):
    if name not in meta:
      continue
    try:
      ds = get_dataset(name)
    except Exception as e:  # a name without its files: record the gap
      rows.append({"Keyword": name, "Error": type(e).__name__})
      continue
    y_omic = ("proteomic" if "proteomic" in ds.omics else
              "celltype" if "celltype" in ds.omics else None)
    rows.append({
        "Keyword": name,
        "#Cells": ds.shape[0],  # the shape only: never densify for this
        "#Genes": ds.shape[1],
        "#Labels": ds.get_dim(y_omic) if y_omic else 0,
        "Binary": bool(ds.is_binary(y_omic)) if y_omic else False,
        "Labels": ", ".join(standardize_protein_name(str(i))
                            for i in ds.get_var_names(y_omic)[:24])
                  if y_omic else "",
    })
  return _html_table(rows) if return_html else rows


def get_dataset(name: str, override: bool = False, verbose: bool = False,
                **kwargs) -> SingleCellOMIC:
  """A dataset → ``SingleCellOMIC``: a ``.h5ad`` file through
  ``read_h5ad``, a CellRanger ``.h5`` through ``read_10x_h5``, a matrix
  directory (``matrix.mtx[.gz]``) through ``read_10x_mtx``, else a
  registry alias through its loader, which takes ``override`` (rebuild
  the cache) and ``verbose`` when its signature has them."""
  path = str(name)
  if path.endswith(".h5ad") and os.path.isfile(path):
    return read_h5ad(path)
  if path.endswith((".h5", ".hdf5")) and os.path.isfile(path):
    return read_10x_h5(path)
  if os.path.isdir(path) and any(
      os.path.isfile(os.path.join(path, m))
      for m in ("matrix.mtx", "matrix.mtx.gz")):
    return read_10x_mtx(path)
  key = path.lower().strip()
  meta = get_dataset_meta()
  if key not in meta:
    close = difflib.get_close_matches(key, meta.keys(), n=5)
    raise KeyError(f"Unknown dataset '{key}'. Did you mean {close}? "
                   f"({len(meta)} datasets registered)")
  fn = meta[key]
  params = inspect.signature(
      fn.func if isinstance(fn, partial) else fn).parameters
  if "override" in params:
    kwargs["override"] = override
  if "verbose" in params:
    kwargs["verbose"] = verbose
  return fn(**kwargs)
