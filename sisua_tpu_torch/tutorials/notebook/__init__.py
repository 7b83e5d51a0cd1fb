"""The port's notebook (``sisua_tpu_torch_basic_tutorial.ipynb``, the
counterpart of the JAX package's basic tutorial) and ``run``, which
executes its code cells in order in one namespace, as a kernel would.

  python -m sisua_tpu_torch.tutorials.notebook [--device cpu] [--depth N]
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import Dict

import numpy as np

from .._common import at_depth, device_of, out_dir_of

PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "sisua_tpu_torch_basic_tutorial.ipynb")
EPOCHS = 25        # the notebook's ``epochs``
FAST_EPOCHS = 16   # and ``fast_epochs``


def code_cells():
  with open(PATH) as f:
    nb = json.load(f)
  return ["".join(c["source"]) for c in nb["cells"]
          if c["cell_type"] == "code"]


def main(device=None, out_dir=None, depth=None, figures=False) -> Dict:
  """Run the notebook's code cells in order. The configuration cell's
  ``device``, ``render``, ``figure_dir``, ``epochs`` and ``fast_epochs``
  are set from the arguments right after it runs (the figures render
  only with ``figures``). Returns the numbers its cells print."""
  out = out_dir_of(out_dir, "notebook")
  ns: Dict = {"__name__": "__notebook__"}
  for i, src in enumerate(code_cells()):
    with contextlib.chdir(out):      # what the cells write lands in out
      exec(compile(src, f"<notebook cell {i}>", "exec"), ns)
    if "fast_epochs" in ns and "nlayers" in ns and "_configured" not in ns:
      ns.update(device=device_of(device), render=bool(figures),
                figure_dir=os.path.join(out, "scvae_figures"),
                epochs=at_depth(EPOCHS, depth),
                fast_epochs=at_depth(FAST_EPOCHS, depth, least=2),
                _configured=True)
  fast = ns["fast"]
  return {"n_genes": ns["n_genes"], "n_prots": ns["n_prots"],
          "protein_prediction": ns["pos"].cal_protein_prediction(),
          "sheet": ns["rs"].get_scores(),
          "median_epoch_seconds": float(np.median(
              fast.history["epoch_time"][1:])),
          "library_draws": [float(np.median(s))
                            for s in ns["library_draws"]]}

