"""The constants the port needs (copy of ``sisua_tpu/data/const.py``'s
``UNIVERSAL_RANDOM_SEED``, ``MARKER_ADT_GENE`` and ``MARKER_ADTS``): the
seed of the data split, and each surface protein (ADT) with the gene that
codes it, the pairs that ``analysis.correlation_scores`` scores."""

from typing import List

__all__ = ["UNIVERSAL_RANDOM_SEED", "MARKER_ADT_GENE", "MARKER_ADTS"]

UNIVERSAL_RANDOM_SEED = 5218

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
