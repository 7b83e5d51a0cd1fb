"""scScope — recurrent imputation autoencoder (Deng et al. 2019), port of
``sisua_tpu/models/scscope.py``.

  * one autoencoder (encoder → deterministic latent → decoder) unrolled for
    ``t_steps`` cycles: cycle t re-encodes ``observed·x + (1 − observed)·imp``,
    the zero entries replaced by the previous cycle's imputation;
  * the imputer (``Imputation``, a D × D Dense) maps the previous cycle's
    reconstruction to replacement values in ``log1p`` space, then relu and
    ``expm1`` back to counts;
  * the loss sums every cycle's main-head reconstruction: the last cycle's
    through the objective (and its kernel route for a count head), the
    earlier ones as ``llk_cycles`` in ``_extra_loss``, in plain
    distribution math as in the JAX package. The default head is 'nzmse'
    (``NonzeroMaskedDeterministic``), which reaches no kernel;
  * the latent is deterministic: a cycle takes no noise and adds no KL.

Gradients flow through the whole recurrence. In train mode every cycle's
BatchNorm updates its running statistics, cycle after cycle, as flax's
one mutable apply does. Intermediate cycles keep the plain (B, D) shape;
only the last one honours ``sample_shape``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..nn import dense
from ..parallel import functional as PF
from ..rv import RVmeta, parse_rv
from .base import SingleCellModel, _flatten
from .module import NoiseRecorder, VAEModule, VAEOutput

__all__ = ["SCScope", "SCScopeModule"]

# heads SCScope keeps; any other main head becomes 'nzmse'
_HEADS = ("nzmse", "mse", "zinb", "nb", "zinbd", "nbd", "poisson")


class SCScopeModule(VAEModule):
  """Unrolled recurrent autoencoder; ``aux_outputs`` carries the
  intermediate cycles' main-head distributions."""

  def __init__(self, outputs, latents, encoder_confs, decoder_confs,
               log_norm: bool = True, reduce_latent: str = "concat",
               n_batch: int = 0, t_steps: int = 2,
               generator: Optional[torch.Generator] = None):
    if int(t_steps) < 1:
      raise ValueError(f"t_steps must be ≥ 1, got {t_steps}")
    super().__init__(outputs, latents, encoder_confs, decoder_confs,
                     log_norm=log_norm, reduce_latent=reduce_latent,
                     n_batch=n_batch, generator=generator)
    self.t_steps = int(t_steps)
    if self.t_steps > 1:  # flax builds it only where a forward calls it
      d = self.outputs[0].dim
      self.Imputation = dense(d, d, generator)

  def forward(self, x, library=None, sample_shape=(), generator=None,
              noise=None) -> VAEOutput:
    x0, b = self.split_batch(x)
    observed = (x0 > 0).to(torch.float32)
    imp = torch.zeros_like(x0)
    aux = []
    for t in range(self.t_steps):
      last = t == self.t_steps - 1
      h_t = observed * x0 + (1.0 - observed) * imp
      qZ = self.encode(self._with_batch(h_t, b), generator)
      zs = self._sample(qZ, sample_shape if last else (), generator, noise)
      if isinstance(noise, NoiseRecorder):
        # recorded once: every cycle reads the same (deterministic) entries
        noise = [None] * len(qZ)
      pX = self.decode(self.reduce_latents(zs), library, generator, b)
      if not last:
        aux.append(pX[0])
        imp = torch.expm1(F.relu(self.Imputation(torch.log1p(pX[0].mean()))))
    return VAEOutput(outputs=pX, latents=qZ, latent_samples=zs,
                     priors=self.latent_priors(library, like=x),
                     aux_outputs=tuple(aux))


class SCScope(SingleCellModel):
  """Recurrent imputation autoencoder; deterministic latent, no KL. The
  main head is kept when it is one of 'nzmse', 'mse' or a count head, else
  coerced to 'nzmse'; latents become 'linear' unless deterministic."""

  module_cls = SCScopeModule

  def __init__(self, outputs, latents=None, latent_dim: int = 50,
               t_steps: int = 2, **kwargs):
    outputs = [parse_rv(o, f"output{i}")
               for i, o in enumerate(_flatten(outputs))]
    if outputs[0].posterior not in _HEADS:
      outputs[0] = outputs[0].replace(posterior="nzmse")
    if latents is None:
      latents = RVmeta(int(latent_dim), "linear", True, "latents")
    else:
      latents = tuple(
          z if z.is_deterministic else z.replace(posterior="linear")
          for z in (parse_rv(z, f"latent{i}")
                    for i, z in enumerate(_flatten(latents))))
    super().__init__(tuple(outputs), latents=latents, t_steps=int(t_steps),
                     **kwargs)

  @property
  def t_steps(self) -> int:
    return self.module.t_steps

  def _extra_loss(self, out: VAEOutput, batch, training: bool):
    """−mean log-prob of each intermediate cycle's main head (every cycle
    weighs the same; the last is in the objective already)."""
    if not out.aux_outputs:
      return None
    x = batch["inputs"][0].to(torch.float32)
    extra = 0.0
    for pX in out.aux_outputs:
      extra = extra - PF.batch_mean(pX.log_prob(x))
    return extra, {"llk_cycles": -extra}
