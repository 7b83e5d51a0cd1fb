"""The constants of the data layer (copy of ``sisua_tpu/data/const.py``):
the seed of the data split, the t-SNE width, each surface protein (ADT)
with the gene that codes it (the pairs ``analysis.correlation_scores``
scores and ``marker_pairs`` gives), the marker genes and ATAC promoter
regions, the co-expressed and opposed protein pairs mined across CITE-seq
datasets, and ``OMIC``, the ordered flag of omic types. The container
names its omics by strings, the ``OMIC`` names; it takes an ``OMIC``
wherever it takes a name, and ``get_all_omics`` gives its omics as
flags."""

import functools
from typing import List, Optional, Tuple

__all__ = ["UNIVERSAL_RANDOM_SEED", "TSNE_DIM", "OMIC", "get_all_omics",
           "MARKER_ADT_GENE", "MARKER_ADTS", "MARKER_GENES", "MARKER_ATAC",
           "PROTEIN_PAIR_POSITIVE", "PROTEIN_PAIR_NEGATIVE", "marker_pairs",
           "omic_markers"]

UNIVERSAL_RANDOM_SEED = 5218
TSNE_DIM = 2

# protein (ADT) → marker gene symbol
MARKER_ADT_GENE = {
    "CD14": "CD14", "CD15": "FUT4", "CD16": "FCGR3A", "CD11c": "ITGAX",
    "CD127": "IL7R", "CD19": "CD19", "CD2": "CD2", "CD25": "IL2RA",
    "CD3": "CD3G", "CD4": "CD4", "CD45RA": "PTPRC", "CD45RO": "PTPRC",
    "CD56": "NCAM1", "CD57": "B3GAT1", "CD8": "CD8A", "CD8a": "CD8A",
    "PD-1": "PDCD1", "TIGIT": "TIGIT", "CD20": "MS4A1", "CD45": "PTPRC",
    "CD34": "CD34", "CD10": "MME", "CD135": "FLT3", "CD38": "CD38",
    "CD49F": "ITGA6", "CD90": "THY1",
}

MARKER_ADTS: List[str] = list(MARKER_ADT_GENE.keys())

MARKER_GENES: List[str] = sorted(
    set(list(MARKER_ADT_GENE.values()) + [
        "CD8B", "CD79A", "LYZ", "LGALS3", "S100A8", "GNLY", "KLRB1",
        "FCER1A", "CST3", "MS4A1", "CD19", "MME", "VPREB1", "VPREB3",
        "DNTT", "MZB1", "NKG7", "CD3D", "CD34", "HBA1", "FCGR3A",
        "GATA1", "GATA2",
    ]))

# ATAC promoter-region markers (reference const.py:123-130)
MARKER_ATAC = {
    "GZMK classic promoter": "chr13:113180223:113181928",
    "GZMK alternative promoter": "chr13:113182148:113184892",
    "CD68 promoter": "chr11:69665600:69667000",
    "CD3D promoter": "chr9:44981200:44982800",
    "CD19 promoter": "chr7:126414200:126415200",
    "NCR1 promoter": "chr7:4337400:4337800",
}

# Representative protein-marker co-expression pairs, mined across CITE-seq
# datasets (reference const.py:15-70; derived by tests/test_oppose_protein_pairs).
PROTEIN_PAIR_POSITIVE: List[Tuple[str, str]] = [
    ("CD3", "CD4"), ("CD14", "CD4"), ("CD19", "CD45RA"), ("CD14", "CD19"),
    ("CD3", "CD8"), ("IgG1", "IgG2a"), ("IgG2a", "IgG2b"), ("IgG1", "IgG2b"),
    ("CD45RO", "PD-1"), ("CD14", "IgG2b"), ("CD19", "IgG2a"), ("CD14", "IgG2a"),
    ("CD19", "IgG1"), ("CD19", "IgG2b"), ("CD14", "CD8"), ("CD14", "IgG1"),
    ("CD4", "IgG2a"), ("CCR7", "CD19"), ("CD4", "IgG1"), ("CCR7", "CD4"),
    ("CD4", "IgG2b"), ("IgG1", "PD-1"), ("CD16", "CD56"), ("CCR7", "CD14"),
    ("IgG2a", "PD-1"), ("CD14", "PD-1"), ("CD4", "PD-1"), ("CD19", "PD-1"),
    ("CCR7", "IgG2a"), ("CCR7", "CD45RA"), ("IgG2b", "PD-1"),
    ("CD16", "CD45RA"), ("CD45RA", "CD56"), ("CD14", "CD3"), ("CCR7", "IgG1"),
    ("CD11c", "CD14"), ("CCR7", "IgG2b"), ("CCR7", "CD3"), ("CD19", "CD4"),
    ("CD45RO", "IgG1"), ("CD16", "CD19"), ("CD19", "CD8"), ("CD14", "CD45RO"),
    ("CD45RA", "CD8"), ("CD127", "CD3"), ("CD45RA", "IgG2a"), ("CD8", "PD-1"),
    ("CD4", "CD45RO"), ("CD127", "CD4"), ("CD8", "IgG2a"), ("CD8", "IgG1"),
    ("CD45RO", "CD8"), ("CD11c", "CD16"), ("CD45RA", "IgG2b"), ("CD3", "IgG2a"),
    ("CD14", "HLA-DR"), ("HLA-DR", "IgG1"), ("HLA-DR", "PD-1"), ("CD3", "IgG1"),
    ("CCR7", "HLA-DR"), ("CD8", "HLA-DR"), ("CD19", "HLA-DR"), ("CD19", "CD56"),
    ("HLA-DR", "IgG2a"), ("CD3", "CD45RO"), ("CCR7", "CD8"), ("CD8", "IgG2b"),
    ("CD3", "PD-1"), ("CD3", "IgG2b"), ("CD10", "CD34"), ("CD45RO", "HLA-DR"),
    ("CD14", "CD16"), ("HLA-DR", "IgG2b"), ("CD2", "CD3"), ("CCR7", "PD-1"),
    ("CD4", "HLA-DR"), ("CD25", "CD45RO"), ("CD25", "PD-1"), ("CD56", "TIGIT"),
    ("CCR7", "CD34"), ("CD16", "TIGIT"), ("CD45RA", "IgG1"), ("CD127", "CD28"),
    ("CD16", "CD34"), ("CCR7", "CD10"), ("CCR5", "CD10"), ("CD28", "CD4"),
    ("CD27", "CD28"), ("CCR7", "CD16"), ("CD34", "CD56"), ("CD11c", "CD56"),
    ("PD-1", "TIGIT"), ("CCR5", "CCR7"), ("CD3", "CD45RA"), ("CD11c", "CD34"),
    ("CD3", "HLA-DR"), ("CD15", "IgG2a"), ("CD11c", "CD8"), ("CD14", "CD25"),
    ("CD2", "CD8"),
]
PROTEIN_PAIR_NEGATIVE: List[Tuple[str, str]] = [
    ("CD45RA", "CD45RO"), ("CD3", "CD56"), ("CD16", "CD3"), ("CD4", "CD56"),
    ("CD127", "CD45RA"), ("CD45RA", "PD-1"), ("CD19", "CD2"), ("CD127", "CD56"),
    ("CD11b", "CD27"), ("CD11c", "CD3"), ("CD11b", "CD28"), ("CD127", "CD16"),
    ("CD16", "CD4"), ("CD4", "CD45RA"), ("CD127", "TIGIT"), ("CD11b", "CD127"),
    ("CD11c", "CD2"), ("CD2", "CD27"), ("CD28", "CD8"), ("CD2", "CD45RA"),
    ("CD11b", "CD4"), ("CD127", "CD14"), ("CD3", "TIGIT"), ("CD28", "CD45RA"),
    ("CD127", "CD19"), ("CD4", "CD8"), ("CD27", "CD8"), ("CD11b", "CD3"),
    ("CD11b", "CD5"), ("CD2", "CD62L"), ("CD2", "CD31"), ("CD2", "PD-1;CD279"),
    ("CD2", "CD69"), ("CD2", "MHCII"), ("CD5", "CD56"), ("CD25", "CD45RA"),
    ("CD16", "CD2"), ("CD4", "TIGIT"), ("CCR7", "CD2"), ("CD45RA", "CD5"),
    ("CD2", "CD77"), ("CD26", "CD8"), ("CD5", "HLA-A"), ("CD2", "HLA-A"),
    ("CD44", "CD45RA"), ("CD5", "CD7"), ("CD31", "CD5"), ("CD10", "CD45"),
    ("CD31", "CD44"), ("CD5", "CD8"), ("CD34", "CD45"), ("CD31", "CD4"),
    ("CD5", "CD77"), ("CD27", "CD56"), ("CD11b", "CD26"), ("CD11b", "CD44"),
    ("CD27", "HLA-A"), ("CD8", "PD-1;CD279"), ("CD38", "CD90"),
    ("CD7", "MHCII"), ("CD366", "CD5"), ("CD278", "HLA-DR"), ("CD11b", "CD278"),
    ("CD366", "CD44"), ("CD2", "CD66b"), ("CD127", "HLA-DR"), ("CD34", "CD4"),
    ("CD28", "HLA-DR"), ("CD27", "HLA-DR"), ("CD3", "CD69"), ("CD3", "CD366"),
    ("CD8", "PD1;CD279"), ("CD44", "CD7"), ("CD278", "CD86"), ("CD19", "CD5"),
    ("CD27", "CD45RA"), ("CD44", "CD77"), ("CD62L", "CD8"), ("CD27", "MHCII"),
    ("CD2", "CD28"), ("CD3", "CD86"), ("CD2", "CD366"), ("CD44", "CD56"),
    ("CD26", "CD45RA"), ("CD127", "MHCII"), ("CD5", "MHCII"), ("CD16", "CD27"),
    ("CD3", "CD34"), ("CD127", "CD86"), ("CD16", "CD5"), ("CD28", "CD86"),
    ("CD27", "CD86"), ("CD28", "CD56"), ("CD2", "LAMP1"), ("CD14", "CD27"),
    ("CD127", "CD2"), ("CD14", "CD278"), ("CCR7", "CD44"), ("CD16", "CD44"),
    ("CD2", "CD34"),
]

_RNA = ("transcriptomic", "itranscriptomic")
_ADT = ("proteomic", "iproteomic")


def omic_markers(omic: str) -> Optional[List[str]]:
  """The marker names of an omic (the JAX ``OMIC.markers``): proteins,
  genes or ATAC regions; None for any other omic."""
  if omic in _ADT:
    return list(MARKER_ADTS)
  if omic in _RNA:
    return list(MARKER_GENES)
  if omic in ("atac", "iatac"):
    return list(MARKER_ATAC)
  return None


def marker_pairs(omic1: str, omic2: str) -> Optional[List[Tuple[str, str]]]:
  """The known (omic1 var, omic2 var) marker pairs of a gene and a protein
  omic, in either order (the JAX ``OMIC.marker_pairs``); None for any
  other two omics."""
  if omic1 in _RNA and omic2 in _ADT:
    return [(g, p) for p, g in MARKER_ADT_GENE.items()]
  if omic1 in _ADT and omic2 in _RNA:
    return [(p, g) for p, g in MARKER_ADT_GENE.items()]
  return None


# ---------------------------------------------------------------------------
# OMIC ordered flag
# ---------------------------------------------------------------------------
_BASE_OMICS = (
    "genomic", "atac", "transcriptomic", "proteomic", "celltype", "tissue",
    "disease", "progenitor", "pmhc", "rpkm", "ercc",
    # reconstructed
    "oatac", "otranscriptomic",
    # imputed mirrors
    "igenomic", "iatac", "itranscriptomic", "iproteomic", "icelltype",
    "itissue", "idisease", "iprogenitor", "ipmhc", "irpkm", "iercc",
    #
    "epigenomic", "metabolomic", "microbiomic",
    # others
    "latent",
)
_ORDER = {n: i for i, n in enumerate(_BASE_OMICS)}
_IMPUTED = {"igenomic", "iatac", "itranscriptomic", "iproteomic", "icelltype",
            "idisease", "iprogenitor", "ipmhc"}


@functools.total_ordering
class OMIC:
  """Ordered string flag of omic types (combinable with ``|``).

  ``OMIC.transcriptomic | OMIC.proteomic`` has the name
  ``'transcriptomic_proteomic'`` and iterates its members in declaration
  order; a flag equals its name as a string.
  """

  __slots__ = ("_names",)

  def __init__(self, names: Tuple[str, ...]):
    object.__setattr__(self, "_names", tuple(sorted(set(names),
                                                    key=_ORDER.__getitem__)))

  # -- construction -----------------------------------------------------
  @classmethod
  def parse(cls, o) -> "OMIC":
    if isinstance(o, OMIC):
      return o
    s = str(o).lower().strip()
    names = [n for n in s.split("_") if n]
    for n in names:
      if n not in _ORDER:
        raise ValueError(f"Unknown OMIC type '{n}' in {o!r}; "
                         f"supported: {list(_BASE_OMICS)}")
    return cls(tuple(names))

  @classmethod
  def is_omic_type(cls, o) -> bool:
    try:
      cls.parse(o)
      return True
    except ValueError:
      return False

  # -- flag protocol ------------------------------------------------------
  @property
  def name(self) -> str:
    return "_".join(self._names)

  def __or__(self, other) -> "OMIC":
    other = OMIC.parse(other)
    return OMIC(self._names + other._names)

  def __and__(self, other) -> "OMIC":
    other = OMIC.parse(other)
    return OMIC(tuple(n for n in self._names if n in other._names))

  def __contains__(self, other) -> bool:
    other = OMIC.parse(other)
    return all(n in self._names for n in other._names)

  def __iter__(self):
    for n in self._names:
      yield OMIC((n,))

  def __len__(self):
    return len(self._names)

  def __eq__(self, other):
    if other is None:
      return False
    try:
      return self._names == OMIC.parse(other)._names
    except ValueError:
      return False

  def __lt__(self, other):
    return tuple(_ORDER[n] for n in self._names) < tuple(
        _ORDER[n] for n in OMIC.parse(other)._names)

  def __hash__(self):
    return hash(self._names)

  def __repr__(self):
    return f"<OMIC.{self.name}>"

  def __str__(self):
    return self.name

  # -- domain properties ------------------------------------------------
  @property
  def is_imputed(self) -> bool:
    return len(self._names) == 1 and self._names[0] in _IMPUTED

  @property
  def markers(self) -> Optional[List[str]]:
    return omic_markers(self.name)

  def marker_pairs(self, omic) -> Optional[List[Tuple[str, str]]]:
    return marker_pairs(self.name, OMIC.parse(omic).name)


# the base members as class attributes: OMIC.transcriptomic etc.
for _n in _BASE_OMICS:
  setattr(OMIC, _n, OMIC((_n,)))
del _n


def get_all_omics(sco) -> List[OMIC]:
  """The omics of a container, as flags, in its order."""
  return [OMIC.parse(n) for n in sco.omics]
