"""Dataset loaders: raw files → preprocess → cache → SingleCellOMIC (port
of ``sisua_tpu/data/loaders``, without pandas).

Every loader follows one pattern: the raw files (a public URL or a GEO
accession) are found in DOWNLOAD_DIR, or downloaded there when absent,
preprocessed into DATA_DIR/<name>_preprocessed (npz files and an MD5
manifest, the JAX package's format), and the cached matrices wrapped as a
SingleCellOMIC with 1–3 omics. A valid cache is read without touching the
raw files; offline, a missing raw file raises an error that names where to
place it. h5py, ``cryptography``, scvi-tools and rpy2 are imported only by
the readers that need them.
"""

from .tenx import read_dataset10x
from .pbmc8k import read_PBMC8k
from .pbmcecc import read_PBMCeec
from .citeseq import read_CITEseq_CBMC, read_CITEseq_PBMC
from .facs import read_FACS, read_full_FACS
from .scvi_datasets import read_Cortex, read_Hemato, read_PBMC, read_Retina
from .leukemia import read_leukemia_BMMC, read_leukemia_MixedPhenotypes
from .misc import (read_centenarian, read_human_embryos,
                   read_melanoma_cisTopicData, read_mouse_ATLAS,
                   read_scale_dataset)
from .cross import read_PBMC_crossdataset, read_PBMC_crossdataset_remove_protein

__all__ = [
    "read_dataset10x", "read_PBMC8k", "read_PBMCeec", "read_CITEseq_CBMC",
    "read_CITEseq_PBMC", "read_FACS", "read_full_FACS", "read_Cortex",
    "read_Hemato", "read_PBMC", "read_Retina", "read_leukemia_BMMC",
    "read_leukemia_MixedPhenotypes", "read_centenarian", "read_human_embryos",
    "read_melanoma_cisTopicData", "read_mouse_ATLAS", "read_scale_dataset",
    "read_PBMC_crossdataset", "read_PBMC_crossdataset_remove_protein",
]
