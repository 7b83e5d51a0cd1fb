"""Export of ``SingleCellOMIC`` datasets to scvi-tools and AnnData (port of
``sisua_tpu/data/sisua_to_scvi.py``), for users who benchmark against the
scVI ecosystem. anndata, scvi-tools and pandas (which anndata brings) are
imported by the calls; without anndata or scvi-tools they raise the JAX
package's ``RuntimeError``s.
"""

from __future__ import annotations

import numpy as np

__all__ = ["sisua_to_anndata", "sisua_to_scvi", "FacsDataset",
           "PbmcCiteseqDataset"]


def sisua_to_anndata(sco, omic=None):
  """SingleCellOMIC → ``anndata.AnnData``: the omic (default the current
  one) as X, the obs columns, the argmax label of each label omic in obs,
  the protein counts in ``obsm['protein_expression']``."""
  try:
    import anndata
  except ImportError as e:
    raise RuntimeError(
        "anndata is not installed in this environment; install it to export "
        "(the sisua_tpu container itself never needs it)") from e
  import pandas as pd
  from .const import OMIC
  omic = OMIC.parse(sco.current_omic if omic is None else omic).name
  obs = pd.DataFrame({k: v for k, v in sco.obs.items() if k != "cell_id"},
                     index=pd.Index(sco.obs["cell_id"], name="cell_id"))
  adata = anndata.AnnData(
      X=sco.get_omic(omic), obs=obs,
      var=pd.DataFrame(index=sco.get_var_names(omic)))
  for cand in ("celltype", "disease", "progenitor"):
    if cand in sco.omics:
      names = sco.get_var_names(cand)
      adata.obs[cand] = np.asarray(names)[np.argmax(sco.numpy(cand), 1)]
  if "proteomic" in sco.omics:
    adata.obsm["protein_expression"] = sco.numpy("proteomic")
    adata.uns["protein_names"] = list(sco.get_var_names("proteomic"))
  return adata


def sisua_to_scvi(sco, omic=None):
  """SingleCellOMIC → an AnnData registered with scvi-tools
  (``SCVI.setup_anndata``, the cell types as labels when present)."""
  try:
    import scvi
  except ImportError as e:
    raise RuntimeError("scvi-tools is not installed; pip install scvi-tools "
                       "to export for cross-library benchmarking") from e
  adata = sisua_to_anndata(sco, omic)
  kw = {}
  if "celltype" in adata.obs:
    kw["labels_key"] = "celltype"
  scvi.model.SCVI.setup_anndata(adata, **kw)
  return adata


def FacsDataset(n_protein: int = 5):
  """The FACS dataset in scVI's format."""
  from .loaders.facs import read_FACS
  return sisua_to_scvi(read_FACS(n_protein))


def PbmcCiteseqDataset():
  """The CITE-seq PBMC dataset in scVI's format."""
  from .loaders.citeseq import read_CITEseq_PBMC
  return sisua_to_scvi(read_CITEseq_PBMC())
