"""Hyper-parameter search (port of ``sisua_tpu/models/hyper_params.py``).

* ``fit_hyper``: random or quasi-TPE search over network depth, width,
  latent size and learning rate on a registry dataset, each trial in a
  spawned process (or in this one) on the caller's device. The same
  proposals as the JAX function for the same seed and trial history: one
  ``RandomState(seed)`` drawn in the same order.
* ``fit_hyper_vmap``: every lr × seed trial at once as one member of a
  ``VmapEnsemble``: each member's learning rate rides in the stacked
  optimizer state (the JAX package's ``optax.inject_hyperparams``), and
  the members draw their own batches.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["fit_hyper", "fit_hyper_vmap", "DEFAULT_SPACE"]

DEFAULT_SPACE = {
    "nlayers": (1, 2, 3, 4),
    "hdim": (32, 64, 128, 256),
    "zdim": (4, 8, 16, 32),
    "learning_rate": (1e-4, 3e-4, 1e-3, 3e-3),
}


def _sample(space: Dict[str, Sequence], rng: np.random.RandomState) -> Dict:
  return {k: v[rng.randint(len(v))] for k, v in space.items()}


def _tpe_sample(space, trials: List[Tuple[Dict, float]],
                rng: np.random.RandomState, n_candidates: int = 24) -> Dict:
  """Rank random candidates by P(good)/P(bad) from categorical densities
  of the best and the other trials (a discrete TPE), once 8 trials are
  in."""
  if len(trials) < 8:
    return _sample(space, rng)
  losses = np.array([t[1] for t in trials])
  cut = np.quantile(losses, 0.25)
  good = [t[0] for t in trials if t[1] <= cut]
  bad = [t[0] for t in trials if t[1] > cut]

  def density(configs, key, value):
    counts = sum(1 for c in configs if c[key] == value) + 1.0
    return counts / (len(configs) + len(space[key]))

  best_score, best_cfg = -np.inf, None
  for _ in range(n_candidates):
    cfg = _sample(space, rng)
    score = sum(np.log(density(good, k, v)) - np.log(density(bad, k, v))
                for k, v in cfg.items())
    if score > best_score:
      best_score, best_cfg = score, cfg
  return best_cfg


def _trial_worker(payload):
  """One trial: the dataset split 0.9, a model of the trial's sizes on
  ``device``, fitted; (config, final validation loss, error or None)."""
  (model_name, dataset_name, cfg, epochs, batch_size, seed, device) = payload
  from .. import models as M
  from ..data import get_dataset
  from ..nn import NetConf
  from ..rv import RVmeta
  from ..data.adapters import fit_sco
  try:
    sco = get_dataset(dataset_name)
    train, valid = sco.split(0.9, seed=seed)
    cls = M.get_model(model_name)
    hdim, nlayers, zdim = cfg["hdim"], cfg["nlayers"], cfg["zdim"]
    nets = dict(encoder=NetConf((hdim,) * nlayers, batchnorm=True),
                decoder=NetConf((hdim,) * nlayers, batchnorm=True))
    outputs = [sco.get_rv(o) for o in list(sco.omics)]
    if issubclass(cls, M.SCVI) and outputs[0].posterior in ("zinb", "nb"):
      # scVI's family takes the transcriptome as 'zinbd' or 'nbd' only: the
      # JAX worker passes get_rv's 'zinb', and every such trial fails there
      outputs[0] = dataclasses.replace(
          outputs[0], posterior=outputs[0].posterior + "d")
    is_semi = getattr(cls, "mask_outputs", False)
    model = cls(outputs if is_semi else outputs[0],
                latents=RVmeta(zdim, "diag", True, "latents"),
                seed=seed, device=device, **nets)
    fit_sco(model, train, valid=valid, epochs=epochs, batch_size=batch_size,
            learning_rate=float(cfg.get("learning_rate", 1e-3)),
            labels_percent=0.8, patience=5)
    loss = float(model.history.get("val_loss", model.history["loss"])[-1])
    return cfg, loss, None
  except Exception as e:  # noqa: BLE001 — trial failures are data
    return cfg, float("inf"), repr(e)


def fit_hyper(model: str,
              dataset: str = "synthetic",
              space: Optional[Dict[str, Sequence]] = None,
              algorithm: str = "tpe",
              max_evals: int = 20,
              epochs: int = 10,
              batch_size: int = 64,
              seed: int = 8,
              n_processes: int = 1,
              save_path: Optional[str] = None,
              verbose: bool = False,
              device: str = "cuda") -> Dict[str, Any]:
  """Search the space; returns {'best': cfg, 'loss', 'trials', 'errors'}.
  ``algorithm``: 'rand' or 'tpe'. With ``n_processes > 1`` the trials run
  in waves of spawned processes (so 'tpe' sees every finished wave), all
  on ``device``. A trial that raises scores ``inf`` and its error is
  kept in 'errors'."""
  if algorithm not in ("rand", "tpe"):
    raise ValueError(f"algorithm must be 'rand' or 'tpe', got {algorithm!r}")
  space = dict(space or DEFAULT_SPACE)
  rng = np.random.RandomState(seed)
  trials: List[Tuple[Dict, float]] = []
  errors: List[str] = []

  def propose():
    return (_sample(space, rng) if algorithm == "rand"
            else _tpe_sample(space, trials, rng))

  def record(cfg, loss, err, tag):
    trials.append((cfg, loss))
    if err:
      errors.append(err)
    if verbose:
      print(f"[hyper] {tag}{cfg} → {loss:.4f}" + (f" ({err})" if err else ""))

  if n_processes > 1:
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    with ctx.Pool(n_processes) as pool:
      done = 0
      while done < max_evals:
        wave = min(n_processes, max_evals - done)
        pending = [(model, dataset, propose(), epochs, batch_size,
                    seed + done + i, device) for i in range(wave)]
        for cfg, loss, err in pool.imap_unordered(_trial_worker, pending):
          record(cfg, loss, err, "")
        done += wave
  else:
    for i in range(max_evals):
      cfg, loss, err = _trial_worker(
          (model, dataset, propose(), epochs, batch_size, seed + i, device))
      record(cfg, loss, err, f"{i:02d} ")

  finite = [(c, l) for c, l in trials if np.isfinite(l)]
  best_cfg, best_loss = (min(finite, key=lambda t: t[1]) if finite
                         else (None, float("inf")))
  result = {"best": best_cfg, "loss": best_loss,
            "trials": [{"config": c, "loss": l} for c, l in trials],
            "errors": errors}
  if save_path:
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    with open(save_path, "w") as f:
      json.dump(result, f, indent=2, default=float)
  return result


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
