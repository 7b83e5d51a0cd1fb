"""Trainer — the device-resident training loop (port of
``sisua_tpu/train/trainer.py``: ``make_optimizer`` and the semantics of
``_fit_device_cached``).

The JAX trainer compiles a whole epoch into one executable because its TPU
sat behind a slow link. PyTorch runs eagerly; what carries over is the
contract:
  * the training matrices and library stats live on the device for the
    run; every matrix of a batch is gathered with the same rows;
  * one random permutation per epoch, ``n // batch_size`` full batches;
  * the semi-supervised mask is Bernoulli(``labels_percent``), drawn ONCE
    per run (a fixed labeled subset, as the reference caches it);
  * per-step metrics are summed on the device and fetched to the host once
    per window of ``metrics_interval`` epochs, one history entry per epoch;
  * ``valid`` is evaluated once per window (eval mode, mask = 1) and its
    metrics land as ``val_<metric>`` on the window's last epoch;
  * only the window's last epoch, and only when the whole window is
    finite, may set the best state; the monitored value is ``val_loss``,
    else ``loss``, and must beat the best by ``min_delta``;
  * ``patience`` counts epochs: a window that does not improve charges all
    of its epochs; on reaching it the run stops and, with
    ``allow_rollback``, restores the best state;
  * ``max_iter`` is checked at window boundaries;
  * a non-finite epoch loss stops the run and, with ``allow_rollback``,
    restores the best state;
  * callbacks (``TrainingCallback``) in the JAX order: ``set_model`` first;
    ``on_epoch_begin`` for every epoch of a window before it runs (with
    one logs dict per window, copied into each epoch's logs);
    ``on_epoch_end`` before the epoch's logs are recorded, so a metric a
    callback adds lands in ``history``; ``on_train_end`` once;
  * ``checkpoint_fn(model)`` runs each time a new best is set;
  * ``device_dtype`` 'int16' (exact for integral counts below 32,767 in
    magnitude, else it raises) or 'bfloat16' (lossy) stores the resident
    matrices in 2 bytes an element; each batch is widened to float32 right
    after its gather.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.utils import int16_exact
from .optim import OPTIMIZERS, make_inner_optimizer

__all__ = ["Trainer", "TrainingCallback", "ClippedOptimizer", "ClippedAdam",
           "clip_by_global_norm_"]

_DEVICE_DTYPES = {"float32": torch.float32, "int16": torch.int16,
                  "bfloat16": torch.bfloat16}


class TrainingCallback:
  """Keras-style callback protocol (the JAX package's, ``set_model``,
  ``on_epoch_begin``, ``on_epoch_end``, ``on_train_end``)."""

  def set_model(self, model):
    self.model = model

  def on_epoch_begin(self, epoch: int, logs: Dict):
    pass

  def on_epoch_end(self, epoch: int, logs: Dict):
    pass

  def on_train_end(self, logs: Dict):
    pass


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


class ClippedOptimizer:
  """``optax.chain(clip_by_global_norm(clipnorm), <optimizer>(lr))`` over
  ``params`` (``optim.py``; no clip when ``clipnorm`` is 0). Under
  ``freeze`` the caller passes the trainable parameters only: optax's
  ``masked`` wraps the whole chain, so the clip's global norm counts them
  alone, and the state exists only for them."""

  def __init__(self, params, learning_rate: float, clipnorm: float,
               name: str = "adam"):
    self.name = name
    self.params = [p for p in params if p.requires_grad]
    self.clipnorm = float(clipnorm)
    self.inner = make_inner_optimizer(name, self.params, learning_rate)

  def step(self):
    if self.clipnorm > 0:
      clip_by_global_norm_(self.params, self.clipnorm)
    self.inner.step()

  def state_dict(self):
    return self.inner.state_dict()

  def load_state_dict(self, state):
    self.inner.load_state_dict(state)

  def carry_state(self, other: "ClippedOptimizer") -> None:
    """Continue ``other``'s optimizer state (moments, step count) under
    this call's hyperparameters, as the JAX ``fit`` keeps ``opt_state``
    across calls while it builds the transform anew from the call's
    arguments. Needs the same optimizer over the same parameters."""
    state = other.state_dict()
    if isinstance(self.inner, torch.optim.Optimizer):
      state = dict(state, param_groups=self.inner.state_dict()[
          "param_groups"])
    self.load_state_dict(state)


class ClippedAdam(ClippedOptimizer):
  """``optax.chain(clip_by_global_norm(clipnorm), adam(lr))``."""

  def __init__(self, params, learning_rate: float, clipnorm: float):
    super().__init__(params, learning_rate, clipnorm, "adam")


class Trainer:
  """Drives a model's train step over device-resident matrices."""

  def __init__(self,
               optimizer: str = "adam",
               learning_rate: float = 1e-3,
               clipnorm: float = 100.0,
               patience: int = 20,
               min_delta: float = 1e-4,
               terminate_on_nan: bool = True,
               allow_rollback: bool = True,
               max_iter: Optional[int] = None,
               metrics_interval: int = 1,
               device_dtype: str = "float32",
               verbose: bool = False):
    if optimizer != "adam" and optimizer not in OPTIMIZERS:
      raise ValueError(f"unknown optimizer {optimizer!r}; one of "
                       f"{sorted(['adam', *OPTIMIZERS])}")
    if device_dtype not in _DEVICE_DTYPES:
      raise ValueError(f"device_dtype must be float32|bfloat16|int16, "
                       f"got {device_dtype!r}")
    self.optimizer_name = optimizer
    self.device_dtype = device_dtype
    self.learning_rate = float(learning_rate)
    self.clipnorm = float(clipnorm or 0.0)
    self.patience = int(patience)
    self.min_delta = float(min_delta)
    self.terminate_on_nan = bool(terminate_on_nan)
    self.allow_rollback = bool(allow_rollback)
    self.max_iter = max_iter
    self.metrics_interval = max(1, int(metrics_interval))
    self.verbose = bool(verbose)
    self.history: Dict[str, List[float]] = {}

  def make_optimizer(self, params) -> ClippedOptimizer:
    return ClippedOptimizer(params, self.learning_rate, self.clipnorm,
                            self.optimizer_name)

  def resident(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The training matrices in ``device_dtype``: int16 only when every
    value is an integer below 32,767 in magnitude (else it raises, as the
    JAX trainer does); bf16 rounds."""
    dt = _DEVICE_DTYPES[self.device_dtype]
    if dt == torch.float32:
      return list(xs)
    if dt == torch.int16 and not all(int16_exact(x) for x in xs):
      raise ValueError(
          "device_dtype='int16' needs integer counts < 32768; use "
          "'bfloat16' (lossy) or 'float32' for this dataset")
    return [x.to(dt) for x in xs]

  def fit(self, model, xs: Sequence[torch.Tensor],
          library: Optional[torch.Tensor], epochs: int, batch_size: int,
          labels_percent: float, generator: torch.Generator,
          valid: Optional[Tuple[Sequence[torch.Tensor],
                                Optional[torch.Tensor]]] = None,
          callbacks: Sequence[TrainingCallback] = (),
          checkpoint_fn: Optional[Callable] = None) -> None:
    """Train ``model`` (its ``_train_step(batch) -> metrics``) on the
    device-resident matrices ``xs`` (each (n, D_i), float32 or
    ``device_dtype``) and ``library`` (n, 2); ``valid`` is ``(matrices,
    library)``, evaluated by ``model._evaluate``."""
    for cb in callbacks:
      cb.set_model(model)
    n = int(xs[0].shape[0])
    B = min(int(batch_size), n)
    steps = n // B
    dev = xs[0].device
    mask_all = (torch.rand((n,), generator=generator, device=dev)
                < float(labels_percent)).to(torch.float32)
    best_loss = np.inf
    best = model._snapshot()
    wait = 0
    if self.max_iter and model.step >= self.max_iter:
      epochs = 0  # warm-started past the step budget: train nothing
    interval = self.metrics_interval
    keys: Optional[List[str]] = None
    epoch, stop = -1, False
    while epoch + 1 < epochs and not stop:
      remaining = epochs - (epoch + 1)
      window = interval if remaining >= interval else 1
      base_logs: Dict[str, float] = {}
      for e in range(epoch + 1, epoch + 1 + window):
        for cb in callbacks:
          cb.on_epoch_begin(e, base_logs)
      t_window = time.perf_counter()
      sums = []
      for _ in range(window):
        perm = torch.randperm(n, generator=generator, device=dev)
        acc = None
        for i in range(steps):
          rows = perm[i * B:(i + 1) * B]
          batch = {"inputs": [x.index_select(0, rows).to(torch.float32)
                              for x in xs],
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
      val = model._evaluate(*valid, batch_size=B) if valid is not None \
          else {}
      window_finite = bool(np.isfinite(per_epoch[:, keys.index("loss")])
                           .all())
      for w in range(window):
        epoch += 1
        logs = dict(base_logs)
        logs.update({k: float(v) / steps for k, v in zip(keys, per_epoch[w])})
        logs["epoch_time"] = dt
        logs["cells_per_sec"] = steps * B / max(dt, 1e-9)
        if w == window - 1:
          logs.update({f"val_{k}": v for k, v in val.items()})
        for cb in callbacks:
          cb.on_epoch_end(epoch, logs)
        for k, v in logs.items():
          self.history.setdefault(k, []).append(v)
        if self.verbose:
          msg = " ".join(f"{k}={logs[k]:.4f}" for k in ("loss", "val_loss")
                         if k in logs)
          print(f"[epoch {epoch:03d}] {msg} ({dt:.3f}s)")
        if self.terminate_on_nan and not np.isfinite(logs["loss"]):
          if self.allow_rollback:
            model._restore(best)
          stop = True
          break
        # only the window's last epoch may set the best: the snapshot is the
        # post-window state
        if w != window - 1:
          continue
        monitored = logs.get("val_loss", logs["loss"])
        if window_finite and monitored < best_loss - self.min_delta:
          best_loss = monitored
          best = model._snapshot()
          if checkpoint_fn is not None:
            checkpoint_fn(model)
          wait = 0
        else:
          wait += window  # patience is in epochs, charged per window
          if self.patience > 0 and wait >= self.patience:
            if self.allow_rollback:
              model._restore(best)
            stop = True
            break
      if self.max_iter and model.step >= self.max_iter:
        stop = True
    for cb in callbacks:
      cb.on_train_end(dict(self.history))
