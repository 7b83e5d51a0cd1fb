"""The ``.h5ad`` (AnnData on disk) reader and writer (port of
``sisua_tpu/data/h5ad.py``), speaking the AnnData HDF5 layout through
h5py, which is imported by each call (without it, an ``ImportError``
names h5py); anndata itself is never needed:

  * ``X``: a dense array, or a csr/csc group (``data``/``indices``/
    ``indptr`` with ``encoding-type``/``shape`` attributes);
  * ``obs``/``var``: ``_index`` and plain, string and categorical columns;
  * ``obsm``: per-cell arrays (protein counts, embeddings, one-hots);
  * ``uns``: scalars and arrays.

``read_h5ad`` makes ``X`` the main omic, and the well-known obsm keys
(``protein_expression``, scvi-tools' CITE-seq convention, and any key
named after an ``OMIC``) further omics; a file written by either
package's ``write_h5ad`` comes back with its omics in their order.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
from scipy import sparse

from .const import OMIC

__all__ = ["read_h5ad", "write_h5ad"]


def _h5py(path: str):
  try:
    import h5py
  except ImportError as e:
    raise ImportError(f"{path}: reading or writing .h5ad needs h5py "
                      "(pip install h5py)") from e
  return h5py


# --------------------------------------------------------------------- read
def _read_matrix(h5py, node):
  if isinstance(node, h5py.Dataset):
    return np.asarray(node)
  enc = node.attrs.get("encoding-type", "csr_matrix")
  if isinstance(enc, bytes):
    enc = enc.decode()
  shape = tuple(node.attrs["shape"]) if "shape" in node.attrs else tuple(
      node.attrs["h5sparse_shape"])
  data = np.asarray(node["data"])
  indices = np.asarray(node["indices"])
  indptr = np.asarray(node["indptr"])
  cls = sparse.csr_matrix if "csr" in enc else sparse.csc_matrix
  return cls((data, indices, indptr), shape=shape)


def _decode(a):
  a = np.asarray(a)
  if a.dtype.kind in ("S", "O"):
    return np.asarray([x.decode() if isinstance(x, bytes) else str(x)
                       for x in a.ravel()]).reshape(a.shape)
  return a


def _read_dataframe(h5py, group) -> Dict[str, np.ndarray]:
  """An AnnData obs/var group → {column: array}, its index under
  '_index'."""
  idx_key = group.attrs.get("_index", "_index")
  if isinstance(idx_key, bytes):
    idx_key = idx_key.decode()
  out: Dict[str, np.ndarray] = {}
  for key in group:
    node = group[key]
    if isinstance(node, h5py.Group):  # categorical: categories + codes
      if "categories" in node and "codes" in node:
        cats = _decode(node["categories"])
        codes = np.asarray(node["codes"])
        out[key] = np.where(codes >= 0, cats[np.clip(codes, 0, None)],
                            "nan")
      continue
    out[key] = _decode(node)
  if idx_key in out:
    out["_index"] = out.pop(idx_key)
  return out


def read_h5ad(path: str, name: Optional[str] = None,
              omic: str = "transcriptomic"):
  """An ``.h5ad`` file as a ``SingleCellOMIC`` (see the module
  docstring). The file's obs columns join the container's; one that
  shares a name with a column the container keeps (the cell ids, the
  source rows, an omic's statistics) is stored as ``file_<name>``."""
  h5py = _h5py(path)
  from .dataset import SingleCellOMIC

  with h5py.File(path, "r") as f:
    X = _read_matrix(h5py, f["X"])
    obs = _read_dataframe(h5py, f["obs"]) if "obs" in f else {}
    var = _read_dataframe(h5py, f["var"]) if "var" in f else {}
    cell_id = obs.pop("_index", None)
    gene_id = var.pop("_index", None)
    obsm = {}
    if "obsm" in f:
      for key in f["obsm"]:
        try:
          obsm[key] = _read_matrix(h5py, f["obsm"][key])
        except (KeyError, TypeError, ValueError):  # another encoding
          pass
    uns = {}
    if "uns" in f:
      for key in f["uns"]:
        node = f["uns"][key]
        if isinstance(node, h5py.Dataset):
          try:
            uns[key] = _decode(node)
          except (TypeError, ValueError):  # another encoding: left out
            pass

  sco = SingleCellOMIC(X, cell_id=cell_id, gene_id=gene_id, omic=omic,
                       name=name or path.split("/")[-1].replace(
                           ".h5ad", ""))
  for col, vals in obs.items():
    if col in sco.obs:
      col = f"file_{col}"
    sco.obs[col] = vals
  # files from write_h5ad carry the omics' order in uns (HDF5 iterates
  # its groups alphabetically)
  order = [str(x) for x in np.ravel(uns.get("omics_order", []))]
  if order:
    obsm = {k: obsm[k] for k in
            [k for k in order if k in obsm]
            + [k for k in obsm if k not in order]}
  for key, m in obsm.items():
    if key in ("protein_expression", "protein_counts"):
      target = OMIC.proteomic
    else:
      try:
        target = OMIC.parse(key)
      except ValueError:
        target = None
    if target is not None and target.name not in sco.omics:
      var_names = None
      for uns_key in (f"{key}_var", key):
        if uns_key in uns and len(np.ravel(uns[uns_key])) == m.shape[1]:
          var_names = [str(x) for x in np.ravel(uns[uns_key])]
          break
      sco.add_omic(target, np.asarray(
          m.todense() if sparse.issparse(m) else m, np.float32), var_names)
    else:
      sco.obsm[key] = m
  sco.uns.update(uns)
  sco._record("read_h5ad", dict(path=path))
  return sco


# -------------------------------------------------------------------- write
def _write_matrix(group, key, m):
  if sparse.issparse(m):
    m = m.tocsr()
    g = group.create_group(key)
    g.attrs["encoding-type"] = "csr_matrix"
    g.attrs["encoding-version"] = "0.1.0"
    g.attrs["shape"] = np.asarray(m.shape, np.int64)
    g.create_dataset("data", data=m.data)
    g.create_dataset("indices", data=m.indices)
    g.create_dataset("indptr", data=m.indptr)
  else:
    group.create_dataset(key, data=np.asarray(m))


def _write_dataframe(f, key, index, columns: Dict[str, np.ndarray]):
  g = f.create_group(key)
  g.attrs["encoding-type"] = "dataframe"
  g.attrs["encoding-version"] = "0.2.0"
  g.attrs["_index"] = "_index"
  g.attrs["column-order"] = np.asarray(list(columns), dtype="S")
  g.create_dataset("_index", data=np.asarray(index, dtype="S"))
  for col, vals in columns.items():
    vals = np.asarray(vals)
    if vals.dtype.kind in ("U", "O"):
      vals = vals.astype("S")
    g.create_dataset(col, data=vals)


def write_h5ad(sco, path: str) -> str:
  """Write a ``SingleCellOMIC`` as ``.h5ad``: the current omic as X, the
  other omics in obsm with their var names in uns, the obs columns (the
  cell ids as the index)."""
  h5py = _h5py(path)
  with h5py.File(path, "w") as f:
    f.attrs["encoding-type"] = "anndata"
    f.attrs["encoding-version"] = "0.1.0"
    _write_matrix(f, "X", sco.X)
    cols = {c: np.asarray(v) for c, v in sco.obs.items() if c != "cell_id"}
    _write_dataframe(f, "obs", sco.obs["cell_id"], cols)
    _write_dataframe(f, "var", sco.var_names, {})
    obsm = f.create_group("obsm")
    uns = f.create_group("uns")
    main = str(sco.current_omic)
    uns.create_dataset("omics_order",
                       data=np.asarray(list(sco.omics), dtype="S"))
    for omic_name in sco.omics:
      if omic_name == main:
        continue
      _write_matrix(obsm, omic_name, sco.numpy(omic_name))
      uns.create_dataset(f"{omic_name}_var",
                         data=np.asarray(sco.get_var_names(omic_name),
                                         dtype="S"))
    for key, m in sco.obsm.items():
      if key not in obsm:
        _write_matrix(obsm, key, m)
  return path
