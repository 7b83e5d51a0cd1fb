"""SingleCellModel — keras-feel wrapper over the torch VAE modules (port of
the fit half of ``sisua_tpu/models/base.py``: ``__init__``, ``_loss``, the
train and eval steps, ``fit`` with validation and early stopping, and
``evaluate``).

The model owns an ``nn.Module`` on an explicit ``device`` (default
``"cuda"``, which raises when there is no card), a ``torch.Generator`` on
that device for the reparameterization noise, dropout masks, the epoch
permutation and the semi-supervised mask, its Adam state and a step
counter. Parameters are initialized on the CPU from the seed and then
moved, so the initial weights do not depend on the device. Data is one
matrix or a list ``[rna, adt, …]`` (one per output; numpy, scipy or
tensor), made device-resident once; the first feeds the encoder and the
rest are label targets. ``predict`` and the rest of the inference half,
checkpoints, ``n_batch`` conditioning and mixed precision are not ported
yet.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..data.utils import get_library_size
from ..interpolation import Interpolation, get_interpolation
from ..nn import NetConf, parse_netconf
from ..rv import RVmeta, parse_rv
from ..train.trainer import Trainer
from .module import VAEModule, VAEOutput
from .objective import compute_loss

__all__ = ["SingleCellModel", "resolve_device"]

UNIVERSAL_RANDOM_SEED = 5218  # sisua_tpu.data.const


def _flatten(x) -> Tuple:
  if x is None:
    return ()
  if isinstance(x, (tuple, list)):
    return tuple(x)
  return (x,)


def resolve_device(device) -> torch.device:
  """``torch.device``; a CUDA device must exist (no silent CPU fallback).
  On CUDA, TF32 is switched off for matmuls and cuDNN: the port is held to
  the JAX package in float32, and TF32 keeps about three digits."""
  device = torch.device(device)
  if device.type == "cuda":
    if not torch.cuda.is_available():
      raise RuntimeError("device='cuda' but torch.cuda.is_available() is "
                         "False; pass device='cpu' explicitly")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
  return device


def _as_device_matrix(a, device) -> torch.Tensor:
  if isinstance(a, torch.Tensor):
    return a.to(device=device, dtype=torch.float32)
  if hasattr(a, "toarray"):  # scipy sparse
    a = a.toarray()
  return torch.as_tensor(np.asarray(a, np.float32), device=device)


class SingleCellModel:
  """Base class of the port's zoo. Subclasses customize via ctor."""

  module_cls = VAEModule
  #: multitask semi-supervised masking of non-primary outputs (SISUA family)
  mask_outputs: bool = False

  def __init__(self,
               outputs: Union[RVmeta, Sequence[RVmeta]],
               latents: Union[RVmeta, Sequence[RVmeta], None] = None,
               encoder: Union[NetConf, Sequence[NetConf], None] = None,
               decoder: Union[NetConf, Sequence[NetConf], None] = None,
               log_norm: bool = True,
               beta: Union[float, Interpolation] = 1.0,
               alpha: float = 1.0,
               analytic: bool = True,
               mask_renorm: bool = False,
               reduce_latent: str = "concat",
               seed: int = UNIVERSAL_RANDOM_SEED,
               device: Union[str, torch.device] = "cuda",
               **module_kwargs):
    self.outputs = tuple(parse_rv(o, f"output{i}")
                         for i, o in enumerate(_flatten(outputs)))
    if latents is None:
      latents = RVmeta(10, "diag", True, "latents")
    self.latents = tuple(parse_rv(z, f"latent{i}")
                         for i, z in enumerate(_flatten(latents)))
    if encoder is None:
      encoder = NetConf((64, 64), batchnorm=True, input_dropout=0.3,
                        name="encoder")
    self.encoder = tuple(parse_netconf(e, f"encoder{i}")
                         for i, e in enumerate(_flatten(encoder)))
    if decoder is None:
      decoder = NetConf((64, 64), batchnorm=True, name="decoder")
    self.decoder = tuple(parse_netconf(d, f"decoder{i}")
                         for i, d in enumerate(_flatten(decoder)))
    self.log_norm = bool(log_norm)
    self.beta = get_interpolation(beta)
    self.alpha = float(alpha)
    self.analytic = bool(analytic)
    self.mask_renorm = bool(mask_renorm)
    self.reduce_latent = reduce_latent
    self.seed = int(seed)
    self.device = resolve_device(device)
    init_gen = torch.Generator().manual_seed(self.seed)
    self.module = self.module_cls(
        self.outputs, self.latents, self.encoder, self.decoder,
        log_norm=self.log_norm, reduce_latent=reduce_latent,
        generator=init_gen, **module_kwargs).to(self.device)
    self.generator = torch.Generator(device=self.device)
    self.generator.manual_seed(self.seed)
    self.step = 0
    self.optimizer = None
    self.trainer: Optional[Trainer] = None

  @property
  def uses_library(self) -> bool:
    """Whether the module consumes the per-cell library stats (SCVI)."""
    return False

  @property
  def is_semi_supervised(self) -> bool:
    return self.mask_outputs and len(self.outputs) > 1

  @property
  def history(self) -> Dict[str, List[float]]:
    return self.trainer.history if self.trainer is not None else {}

  # -------------------------------------------------------------- loss/step
  def _module_input(self, inputs: Sequence[torch.Tensor]) -> torch.Tensor:
    """The encoder's input: the first (main) omic; the rest are labels."""
    return inputs[0]

  def _loss(self, batch, training: bool, beta: float,
            noise: Optional[Sequence[Optional[torch.Tensor]]] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], VAEOutput]:
    """−ELBO of one batch {inputs: [x, …], library?, mask?}. The module is
    put in train or eval mode (BatchNorm batch vs running stats, dropout);
    in train mode BatchNorm updates its running stats. The mask gates the
    label heads only in training."""
    self.module.train(training)
    library = batch.get("library") if self.uses_library else None
    out = self.module(self._module_input(batch["inputs"]), library=library,
                      generator=self.generator, noise=noise)
    loss, metrics = compute_loss(
        out, batch["inputs"], mask=batch.get("mask"), beta=beta,
        alpha=self.alpha, analytic=self.analytic,
        mask_outputs=self.mask_outputs if training else False,
        mask_renorm=self.mask_renorm if training else False)
    return loss, metrics, out

  def _train_step(self, batch) -> Dict[str, torch.Tensor]:
    """One optimizer step; β is the schedule at the current step."""
    loss, metrics, _ = self._loss(batch, True, self.beta(self.step))
    self.optimizer.zero_grad()
    loss.backward()
    self.optimizer.step()
    self.step += 1
    return metrics

  def _eval_step(self, batch) -> Dict[str, torch.Tensor]:
    with torch.no_grad():
      _, metrics, _ = self._loss(batch, False, self.beta(self.step))
    return metrics

  def _snapshot(self) -> Dict:
    """Device-side copy of parameters, buffers, Adam state and step."""
    return {"module": {k: v.detach().clone()
                       for k, v in self.module.state_dict().items()},
            "optimizer": copy.deepcopy(self.optimizer.state_dict()),
            "step": self.step}

  def _restore(self, snap: Dict) -> None:
    self.module.load_state_dict(snap["module"])
    self.optimizer.load_state_dict(snap["optimizer"])
    self.step = snap["step"]

  # -------------------------------------------------------------------- fit
  def _device_data(self, data) -> Tuple[List[torch.Tensor],
                                        Optional[torch.Tensor]]:
    """One matrix or a list of them, one per output, as float32 on the
    device, and the (n, 2) library stats of the first when the model uses
    them (numpy on the host for arrays, as the JAX package computes them;
    on the device for tensors)."""
    mats = list(_flatten(data))
    if len(mats) < len(self.outputs):
      raise ValueError(f"{len(mats)} data matrices for {len(self.outputs)} "
                       "outputs: give one per output, [rna, adt, …]")
    if len({int(m.shape[0]) for m in mats}) != 1:
      raise ValueError("data matrices differ in their number of rows: "
                       f"{[tuple(m.shape) for m in mats]}")
    library = None
    if self.uses_library:
      mean, var = get_library_size(mats[0])
      cat = torch.cat if isinstance(mean, torch.Tensor) else np.concatenate
      library = _as_device_matrix(cat([mean, var], 1), self.device)
    return [_as_device_matrix(m, self.device) for m in mats], library

  def _evaluate(self, xs: Sequence[torch.Tensor],
                library: Optional[torch.Tensor],
                batch_size: int) -> Dict[str, float]:
    """Average metrics over device-resident data in sequential batches (the
    last one ragged), eval mode, mask = 1. Metrics stay on the device until
    one fetch at the end."""
    n = int(xs[0].shape[0])
    acc, keys = None, None
    for s in range(0, n, batch_size):
      b = min(batch_size, n - s)
      batch = {"inputs": [x[s:s + b] for x in xs],
               "mask": torch.ones((b,), device=self.device)}
      if library is not None:
        batch["library"] = library[s:s + b]
      metrics = self._eval_step(batch)
      if keys is None:
        keys = sorted(metrics)
      vec = torch.stack([metrics[k].float() for k in keys]) * b
      acc = vec if acc is None else acc + vec
    return {k: float(v) / n for k, v in zip(keys, acc.cpu().numpy())}

  def fit(self,
          train,
          valid=None,
          epochs: int = 100,
          batch_size: int = 64,
          learning_rate: float = 1e-3,
          optimizer: str = "adam",
          clipnorm: float = 100.0,
          labels_percent: float = 0.8,
          valid_freq: int = 500,
          patience: int = 20,
          min_delta: float = 1e-4,
          terminate_on_nan: bool = True,
          allow_rollback: bool = True,
          max_iter: Optional[int] = None,
          metrics_interval: int = 1,
          verbose: bool = False) -> "SingleCellModel":
    """Train on ``train`` and validate on ``valid`` (each one matrix or a
    list ``[rna, adt, …]``). The device-resident loop validates once per
    window of ``metrics_interval`` epochs, as the JAX package's
    device-resident fit does; ``valid_freq`` (steps) belongs to its
    streaming loop and is accepted for the same signature. Early stopping
    monitors ``val_loss`` (else ``loss``) with ``min_delta`` and
    ``patience`` epochs (``Trainer``)."""
    if not self.is_semi_supervised:
      labels_percent = 0.0
    xs, lib = self._device_data(train)
    val = self._device_data(valid) if valid is not None else None
    trainer = Trainer(optimizer=optimizer, learning_rate=learning_rate,
                      clipnorm=clipnorm, patience=patience,
                      min_delta=min_delta,
                      terminate_on_nan=terminate_on_nan,
                      allow_rollback=allow_rollback, max_iter=max_iter,
                      metrics_interval=metrics_interval, verbose=verbose)
    if self.optimizer is None:
      self.optimizer = trainer.make_optimizer(self.module.parameters())
    trainer.fit(self, xs, lib, epochs=epochs, batch_size=batch_size,
                labels_percent=labels_percent, generator=self.generator,
                valid=val)
    # one history across successive fit calls
    if self.trainer is None:
      self.trainer = trainer
    else:
      for k, v in trainer.history.items():
        self.trainer.history.setdefault(k, []).extend(v)
    return self

  # ---------------------------------------------------------------- evaluate
  def evaluate(self, data, batch_size: int = 256) -> Dict[str, float]:
    """Average loss/LLK/KL metrics over ``data`` (one matrix or a list, as
    in ``fit``), eval mode, mask = 1 as in validation."""
    xs, lib = self._device_data(data)
    return self._evaluate(xs, lib, batch_size)
