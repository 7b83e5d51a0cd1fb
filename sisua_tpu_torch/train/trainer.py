"""Trainer — the device-resident training loop (port of
``sisua_tpu/train/trainer.py``: ``make_optimizer`` and the semantics of
``_fit_device_cached``).

The JAX trainer compiles a whole epoch into one executable because its TPU
sat behind a slow link. PyTorch runs eagerly; what carries over is the
contract:
  * the training matrix and library stats live on the device for the run;
  * one random permutation per epoch, ``n // batch_size`` full batches;
  * the semi-supervised mask is Bernoulli(``labels_percent``), drawn ONCE
    per run (a fixed labeled subset, as the reference caches it);
  * per-step metrics are summed on the device and fetched to the host once
    per window of ``metrics_interval`` epochs, one history entry per epoch;
  * ``max_iter`` is checked at window boundaries;
  * a non-finite epoch loss stops the run and, with ``allow_rollback``,
    restores the best finite state seen at a window boundary.
Validation, early stopping and ``patience`` are not ported yet.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

__all__ = ["Trainer", "ClippedAdam", "clip_by_global_norm_"]


def clip_by_global_norm_(params, max_norm: float) -> torch.Tensor:
  """optax ``clip_by_global_norm``, in place on ``p.grad``: gradients are
  left alone when the global norm is below ``max_norm`` and otherwise
  become g / norm · max_norm. Unlike ``torch.nn.utils.clip_grad_norm_`` no
  1e-6 is added to the norm. Returns the norm; never syncs the host."""
  grads = [p.grad for p in params if p.grad is not None]
  if not grads:
    return torch.zeros(())
  norm = torch.sqrt(torch.stack([torch.sum(g * g) for g in grads]).sum())
  keep = norm < max_norm
  for g in grads:
    g.copy_(torch.where(keep, g, g / norm * max_norm))
  return norm


class ClippedAdam:
  """``optax.chain(clip_by_global_norm(clipnorm), adam(lr))``. optax's Adam
  (eps=1e-8, eps_root=0) is ``torch.optim.Adam``'s update."""

  def __init__(self, params, learning_rate: float, clipnorm: float):
    self.params = [p for p in params if p.requires_grad]
    self.clipnorm = float(clipnorm)
    self.adam = torch.optim.Adam(self.params, lr=learning_rate,
                                 betas=(0.9, 0.999), eps=1e-8)

  def zero_grad(self):
    self.adam.zero_grad(set_to_none=True)

  def step(self):
    if self.clipnorm > 0:
      clip_by_global_norm_(self.params, self.clipnorm)
    self.adam.step()

  def state_dict(self):
    return self.adam.state_dict()

  def load_state_dict(self, state):
    self.adam.load_state_dict(state)


class Trainer:
  """Drives a model's train step over a device-resident matrix."""

  def __init__(self,
               optimizer: str = "adam",
               learning_rate: float = 1e-3,
               clipnorm: float = 100.0,
               terminate_on_nan: bool = True,
               allow_rollback: bool = True,
               max_iter: Optional[int] = None,
               metrics_interval: int = 1,
               verbose: bool = False):
    if optimizer != "adam":
      raise NotImplementedError(f"optimizer {optimizer!r} is not ported "
                                "yet (only 'adam')")
    self.learning_rate = float(learning_rate)
    self.clipnorm = float(clipnorm or 0.0)
    self.terminate_on_nan = bool(terminate_on_nan)
    self.allow_rollback = bool(allow_rollback)
    self.max_iter = max_iter
    self.metrics_interval = max(1, int(metrics_interval))
    self.verbose = bool(verbose)
    self.history: Dict[str, List[float]] = {}

  def make_optimizer(self, params) -> ClippedAdam:
    return ClippedAdam(params, self.learning_rate, self.clipnorm)

  def fit(self, model, x: torch.Tensor, library: Optional[torch.Tensor],
          epochs: int, batch_size: int, labels_percent: float,
          generator: torch.Generator) -> None:
    """Train ``model`` (its ``_train_step(batch) -> metrics``) on the
    device-resident ``x`` (n, D) and ``library`` (n, 2)."""
    n = int(x.shape[0])
    B = min(int(batch_size), n)
    steps = n // B
    dev = x.device
    mask_all = (torch.rand((n,), generator=generator, device=dev)
                < float(labels_percent)).to(torch.float32)
    best_loss = np.inf
    best = model._snapshot()
    if self.max_iter and model.step >= self.max_iter:
      epochs = 0  # warm-started past the step budget: train nothing
    interval = self.metrics_interval
    keys: Optional[List[str]] = None
    epoch, stop = -1, False
    while epoch + 1 < epochs and not stop:
      remaining = epochs - (epoch + 1)
      window = interval if remaining >= interval else 1
      t_window = time.perf_counter()
      sums = []
      for _ in range(window):
        perm = torch.randperm(n, generator=generator, device=dev)
        acc = None
        for i in range(steps):
          rows = perm[i * B:(i + 1) * B]
          batch = {"inputs": [x.index_select(0, rows)],
                   "mask": mask_all.index_select(0, rows)}
          if library is not None:
            batch["library"] = library.index_select(0, rows)
          metrics = model._train_step(batch)
          if keys is None:
            keys = sorted(metrics)
          vec = torch.stack([metrics[k].detach().float() for k in keys])
          acc = vec if acc is None else acc + vec
        sums.append(acc)
      per_epoch = torch.stack(sums).cpu().numpy()  # the window's one fetch
      dt = (time.perf_counter() - t_window) / window
      window_finite = bool(np.isfinite(per_epoch).all())
      for w in range(window):
        epoch += 1
        logs = {k: float(v) / steps for k, v in zip(keys, per_epoch[w])}
        logs["epoch_time"] = dt
        logs["cells_per_sec"] = steps * B / max(dt, 1e-9)
        for k, v in logs.items():
          self.history.setdefault(k, []).append(v)
        if self.verbose:
          print(f"[epoch {epoch:03d}] loss={logs['loss']:.4f} ({dt:.3f}s)")
        if self.terminate_on_nan and not np.isfinite(logs["loss"]):
          if self.allow_rollback:
            model._restore(best)
          stop = True
          break
        # only the window's last epoch may set the best: the snapshot is the
        # post-window state
        if w == window - 1 and window_finite and logs["loss"] < best_loss:
          best_loss = logs["loss"]
          best = model._snapshot()
      if self.max_iter and model.step >= self.max_iter:
        stop = True

