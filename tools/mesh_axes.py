#!/usr/bin/env python3
"""Where a mesh step parts from the single-device step, axis by axis, on
one CUDA card.

    python3 tools/mesh_axes.py

Runs ``chip_smoke.py``'s phase 23 alone (its checks and log lines), then
its 23b fit (SCVI at 33,000 genes, phase 4's nets, 4 steps of 512 rows
from the seeded weights) over gloo worlds of the card's ranks shaped
1 × 2 (the model axis alone: the gene heads split), 2 × 1 (the data
axis alone) and 2 × 2, against the same fit on one device. For a few
leaves it prints step 1's gradients' relative error (entries above 1e-3
of the leaf's largest) and the parameters' difference after step 4, as
quantiles. Prints the card's name and power limit first. Imports
nothing of JAX.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEAVES = ("encoder0.dense0.weight", "MeanScale.weight",
          "Dispersion.weight", "decoder0.dense1.weight",
          "latent_head_latents.latents_params.weight")


def _host(out):
  return {"losses": out["losses"],
          "grads": {k: v.cpu().numpy() for k, v in out["grads"].items()},
          "state": {k: v.cpu().numpy() for k, v in out["state"].items()}}


def _world_fit(shape):
  """23b's fit in one rank of a world of ``shape``; rank 0's arrays."""
  import torch
  import torch.distributed as dist
  import chip_smoke as cs
  from sisua_tpu_torch.parallel import create_mesh
  out = cs._p23b_fit(torch, create_mesh(*shape))
  return _host(out) if dist.get_rank() == 0 else None


def main():
  import numpy as np
  import torch
  sys.path.insert(0, ROOT)
  import chip_smoke as cs
  from sisua_tpu_torch.parallel import spawn
  cs.phase_device(torch)
  cs.phase_build()
  cs.phase_mesh(torch)
  want = _host(cs._p23b_fit(torch, None))
  for shape in ((1, 2), (2, 1), (2, 2)):
    got = spawn(_world_fit, shape[0] * shape[1], backend="gloo",
                args=(shape,), timeout=300)[0]
    cs.log(f"[mesh axes] {shape[0]} × {shape[1]}: losses {got['losses']} "
           f"against one device's {want['losses']}")
    for k in LEAVES:
      g, w = got["grads"][k], want["grads"][k]
      big = np.abs(w) > 1e-3 * np.abs(w).max()
      rel = np.abs(g - w)[big] / np.abs(w)[big]
      d = np.abs(got["state"][k] - want["state"][k])
      cs.log(f"[mesh axes]   {k}: step 1 gradient relative error q50 "
             f"{np.quantile(rel, .5):.2e} q99 {np.quantile(rel, .99):.2e} "
             f"max {rel.max():.2e}; parameters after step "
             f"{cs.P23_STEPS} q50 {np.quantile(d, .5):.2e} q999 "
             f"{np.quantile(d, .999):.2e} max {d.max():.2e}")
  return 0


if __name__ == "__main__":
  sys.exit(main())
