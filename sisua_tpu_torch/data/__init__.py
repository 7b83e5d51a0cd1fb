"""sisua_tpu_torch.data — the data layer, without pandas (counterpart of
``sisua_tpu.data``): the feeder, the library statistics and corruption,
the port's ``SingleCellOMIC`` (``dataset.py``) with the JAX analyzer
(``analysis.py``: QC, filters, PCA/UMAP, neighbours, clusterings, rank
tests, correlations, mutual information and importances, on the card),
the marker tables, the numpy synthetic generators, and ``get_dataset``
over the registry's synthetic family.

``get_dataset`` loads 'synthetic', 'synthetic<k>' (k in 200, 500, 1k, 2k,
5k, 10k, 40k, 100k, 1m) and 'citeseqsim'. Every other name of the JAX
registry raises: its loader downloads the raw data, which the port does
not do. A ``.h5ad`` or CellRanger ``.h5`` file needs h5py, and a 10x
matrix directory the JAX package's readers: both raise too.
"""

from __future__ import annotations

import difflib
import os
from functools import partial
from typing import Callable, Dict

from .const import (MARKER_ADT_GENE, MARKER_ADTS, MARKER_ATAC, MARKER_GENES,
                    PROTEIN_PAIR_NEGATIVE, PROTEIN_PAIR_POSITIVE, TSNE_DIM,
                    UNIVERSAL_RANDOM_SEED, marker_pairs)
from .dataset import SingleCellOMIC
from .feeder import DataFeeder
from .path import CONFIG_PATH, DATA_DIR, DOWNLOAD_DIR, EXP_DIR
from .synthetic import (SYNTHETIC_SIZES, generate_citeseq, generate_multiome,
                        generate_synthetic, read_synthetic)
from .utils import (apply_artificial_corruption, get_library_size,
                    int16_exact, standardize_protein_name)

__all__ = ["DataFeeder", "SingleCellOMIC", "get_dataset", "get_dataset_meta",
           "generate_synthetic", "generate_citeseq", "generate_multiome",
           "read_synthetic", "SYNTHETIC_SIZES", "get_library_size",
           "int16_exact", "apply_artificial_corruption",
           "standardize_protein_name", "MARKER_ADT_GENE", "MARKER_ADTS",
           "MARKER_ATAC", "MARKER_GENES", "PROTEIN_PAIR_NEGATIVE",
           "PROTEIN_PAIR_POSITIVE", "TSNE_DIM", "marker_pairs",
           "UNIVERSAL_RANDOM_SEED", "DATA_DIR", "DOWNLOAD_DIR", "EXP_DIR",
           "CONFIG_PATH"]

# the JAX registry's names whose loaders download (sisua_tpu/data/__init__.py
# ``_registry``); ``tests/test_torch_port_synthetic.py`` holds this list to
# the JAX registry's keys
_DOWNLOADED = frozenset("""
10k 18k 18kall 4k 5k 5k_pbmc_protein_v3 5k_pbmc_protein_v3all 8k 8kall 8kly
8klyall 8kmy 8kmyall 8kx 8kxnoprot atac_v1_pbmc_10k atac_v1_pbmc_10kall
atac_v1_pbmc_5k atac_v1_pbmc_5kall call callall callx cbmcciteseq
cbmcciteseqall cbmcx centenarian cortex ecc eccall eccly ecclyall eccmy
eccmyall eccx embryos embryosall facs facs2 facs5 facs7 heart10k heart_10k_v3
heart_10k_v3all hemato malt_10k_protein_v3 malt_10k_protein_v3all melanomaatac
mouseatlas mpal mpalall mpalatac mpalx neuron10k neuron_10k_v3
neuron_10k_v3all neurons_900 neurons_900all pbmc33k pbmc33kall pbmc3k
pbmc3kall pbmc4k pbmc4kall pbmc68k pbmc68kall pbmc6k pbmc6kall pbmc8k
pbmc8kall pbmc_10k_protein_v3 pbmc_10k_protein_v3all pbmc_1k_protein_v3
pbmc_1k_protein_v3all pbmcciteseq pbmcciteseqall pbmcscvi pbmcx retina
scaleforebrain scaleinsilico scaleleukemia scalesplenocyte t_3k t_3kall t_4k
t_4kall vdj1 vdj1x vdj2 vdj3 vdj4 vdj4x vdj_v1_hs_aggregated_donor1
vdj_v1_hs_aggregated_donor1all vdj_v1_hs_aggregated_donor2
vdj_v1_hs_aggregated_donor2all vdj_v1_hs_aggregated_donor3
vdj_v1_hs_aggregated_donor3all vdj_v1_hs_aggregated_donor4
vdj_v1_hs_aggregated_donor4all
""".split())


def get_dataset_meta() -> Dict[str, Callable]:
  """Name → loader of the port's registry: the synthetic family, as the
  JAX registry names it."""
  meta: Dict[str, Callable] = {"synthetic": read_synthetic}
  for k in SYNTHETIC_SIZES:
    meta[f"synthetic{k}"] = partial(read_synthetic, k)
  meta["citeseqsim"] = generate_citeseq
  return meta


def get_dataset(name: str, override: bool = False, verbose: bool = False,
                **kwargs) -> SingleCellOMIC:
  """A registry dataset → ``SingleCellOMIC``. ``override`` and
  ``verbose`` are the JAX signature's; the synthetic loaders take
  neither."""
  name = str(name)
  if name.endswith((".h5ad", ".h5", ".hdf5")) and os.path.isfile(name):
    raise NotImplementedError(
        f"{name}: reading an AnnData or CellRanger HDF5 file needs h5py, "
        "which the port does not use; convert it to a .npz or .csv of "
        "counts for sisua_tpu_torch.cli.predict")
  if os.path.isdir(name) and any(
      os.path.isfile(os.path.join(name, m))
      for m in ("matrix.mtx", "matrix.mtx.gz")):
    raise NotImplementedError(
        f"{name}: the 10x matrix reader belongs to the JAX package's data "
        "layer, which is not ported")
  key = name.lower().strip()
  meta = get_dataset_meta()
  if key in meta:
    return meta[key](**kwargs)
  if key in _DOWNLOADED:
    raise NotImplementedError(
        f"Dataset '{key}': its loader downloads and preprocesses the raw "
        "data, which the port does not do; the port's registry holds the "
        f"synthetic family only: {sorted(meta)}")
  close = difflib.get_close_matches(key, list(meta) + sorted(_DOWNLOADED),
                                    n=5)
  raise KeyError(f"Unknown dataset '{name}'. Did you mean {close}?")
