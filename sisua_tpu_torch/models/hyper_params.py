"""On-card hyper-parameter search over learning rate × seed (port of
``sisua_tpu/models/hyper_params.py::fit_hyper_vmap``).

Every trial trains at once as one member of a ``VmapEnsemble``: each
member's learning rate rides in the stacked optimizer state (the JAX
package's ``optax.inject_hyperparams``), and the members draw their own
batches. ``fit_hyper``, the process-per-trial search over network sizes on
a named dataset, loads through the JAX package's pandas data layer and is
not ported (ROADMAP A22).
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np

__all__ = ["fit_hyper_vmap"]


def fit_hyper_vmap(model_fn: Callable[[int], Any],
                   train,
                   learning_rates: Sequence[float] = (1e-4, 3e-4, 1e-3, 3e-3),
                   seeds_per_rate: int = 1,
                   epochs: int = 10,
                   batch_size: int = 64,
                   base_seed: int = 8,
                   metrics_interval: int = 1,
                   mesh=None,
                   save_path: Optional[str] = None,
                   verbose: bool = False) -> Dict[str, Any]:
  """All lr × seed trials in one vmapped fleet. ``model_fn(seed)`` must
  build the same architecture for every seed. Returns {'best', 'loss',
  'trials', 'ensemble'}: the best config by final-epoch loss, its loss,
  every trial's config and loss, and the ``VmapEnsemble`` (``extract(i)``
  yields trial i as a standalone model). ``save_path``: everything but
  the ensemble as JSON. ``mesh=`` raises (ROADMAP A21)."""
  from ..train.ensemble import VmapEnsemble
  configs = [{"learning_rate": float(lr), "seed": base_seed + s}
             for lr in learning_rates for s in range(seeds_per_rate)]
  ens = VmapEnsemble(model_fn, n_models=len(configs), base_seed=base_seed)
  # the members numbered serially by VmapEnsemble are rebuilt with the
  # configs' seeds, as in the JAX package
  ens.models = [model_fn(c["seed"]) for c in configs]
  ens.fit(train, epochs=epochs, batch_size=batch_size,
          learning_rate=[c["learning_rate"] for c in configs],
          shared_batches=False, metrics_interval=metrics_interval,
          mesh=mesh, verbose=verbose)
  final = ens.history["loss"][-1]  # (n_models,)
  trials = [{"config": c, "loss": float(l)} for c, l in zip(configs, final)]
  best_i = int(np.argmin(final))
  result = {"best": configs[best_i], "loss": float(final[best_i]),
            "trials": trials, "ensemble": ens}
  if verbose:
    for t in trials:
      print(f"[hyper-vmap] {t['config']} → {t['loss']:.4f}")
  if save_path:
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    with open(save_path, "w") as f:
      json.dump({k: v for k, v in result.items() if k != "ensemble"},
                f, indent=2, default=float)
  return result
