"""Phase 25 of ``chip_smoke.py`` alone on one CUDA card: the card's name
and power limit, the kernels' build, then every tutorial of
``sisua_tpu_torch.tutorials`` and the notebook on the card, at phase 25's
depth, or with ``--full`` at the JAX tutorials' own depth (every epoch,
evaluation, draw and run). Prints the seconds of each, and as its last
line a JSON object of them with the card and the launches.

    python3 tools/tutorials_phase.py [--full]
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

if __name__ == "__main__":
  p = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
  p.add_argument("--full", action="store_true",
                 help="the tutorials' own depth instead of phase 25's")
  args = p.parse_args()
  sys.path.insert(0, ROOT)
  import torch

  import chip_smoke as cs
  smi = cs.phase_device(torch)
  cs.phase_build()
  depth = None if args.full else cs.P25_DEPTH
  launches, seconds = cs.phase_tutorials(
      torch, depth=depth, budget=float("inf") if args.full else cs.P25_BUDGET)
  print(json.dumps({"card": smi, "depth": depth, "seconds": seconds,
                    "total_s": sum(seconds.values()),
                    "launches": launches}), flush=True)
