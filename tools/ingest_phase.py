"""Phase 24 of ``chip_smoke.py`` alone on one CUDA card: the card's name
and power limit, the kernels' build, then the data-ingestion phase (a
CellRanger directory at pbmc_10k_protein_v3's size read three ways, and
SISUA trained on it).

    python3 tools/ingest_phase.py
"""

import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

if __name__ == "__main__":
  sys.path.insert(0, ROOT)
  import torch

  import chip_smoke as cs
  data_root = cs.ingest_data_root()
  try:
    cs.phase_device(torch)
    cs.phase_build()
    print(cs.phase_ingest(torch, data_root), flush=True)
  finally:
    shutil.rmtree(data_root, ignore_errors=True)
