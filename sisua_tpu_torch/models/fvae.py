"""FVAE / SemiFVAE — FactorVAE (Kim & Mnih 2018), port of
``sisua_tpu/models/fvae.py``.

The ELBO gains a γ-weighted total-correlation term estimated by a
density-ratio discriminator D over the latent sample:

    TC(z) ≈ mean(logit₀(z) − logit₁(z))    (training only)

D is a second parameter group (``SingleCellModel.aux``) with its own Adam
(lr 1e-4, no clip), trained after every main step to tell joint latent
draws (class 0) from draws whose columns were each permuted across the
batch (class 1). The generator's gradient reaches the encoder through z;
D's parameters enter the TC term detached, so the main loss leaves no
gradient in them.

The discriminator step draws fresh latents in eval mode from the model's
generator, independent of the generator step's draw. The JAX step applies
the whole module and reads only z (XLA drops the decoder as dead code);
here only the encoder runs and z is drawn, which gives the same values
because the decoder draws no noise.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..nn import dense
from ..parallel import functional as PF
from .base import SingleCellModel, _flatten
from .module import VAEOutput

__all__ = ["FVAE", "SemiFVAE"]


class _TCDiscriminator(nn.Module):
  """Leaky-ReLU (slope 0.2) MLP → 2 logits [joint, permuted]; submodules
  carry the flax names (``dense{i}``, ``logits``)."""

  def __init__(self, in_dim: int, hidden: Sequence[int] = (256, 256, 256),
               generator: Optional[torch.Generator] = None):
    super().__init__()
    self.hidden = tuple(int(u) for u in hidden)
    d = in_dim
    for i, u in enumerate(self.hidden):
      self.add_module(f"dense{i}", dense(d, u, generator))
      d = u
    self.logits = dense(d, 2, generator)

  def forward(self, z: torch.Tensor) -> torch.Tensor:
    h = z
    for i in range(len(self.hidden)):
      h = F.leaky_relu(getattr(self, f"dense{i}")(h), 0.2)
    return self.logits(h)


def _permute_dims(z: torch.Tensor, generator: Optional[torch.Generator] = None,
                  perms=None) -> torch.Tensor:
  """Each latent column shuffled across the batch by its own permutation:
  column i of the result is ``z[perms[i], i]``. ``perms`` is (D, B); else
  the D permutations are drawn from ``generator`` in one call."""
  b, d = z.shape
  if perms is None:
    perms = torch.argsort(torch.rand((d, b), generator=generator,
                                     device=z.device), dim=1)
  else:
    perms = torch.as_tensor(perms, dtype=torch.int64, device=z.device)
  return torch.gather(z, 0, perms.T)


class FVAE(SingleCellModel):
  """FactorVAE: β-VAE + γ·TC adversarial penalty."""

  def __init__(self, outputs, gamma: float = 6.0,
               discriminator_units: Tuple[int, ...] = (256, 256, 256),
               discriminator_lr: float = 1e-4, **kwargs):
    self._disc_units = tuple(int(u) for u in discriminator_units)
    self._disc_lr = float(discriminator_lr)
    super().__init__(outputs, gamma=gamma, **kwargs)
    self._init_kwargs_for_save.update(
        discriminator_units=list(self._disc_units),
        discriminator_lr=self._disc_lr)

  # -------------------------------------------------------------- aux group
  def _latent_dim(self) -> int:
    if self.reduce_latent == "concat":
      return sum(z.dim for z in self.latents)
    return self.latents[0].dim

  def _init_aux(self, generator):
    return _TCDiscriminator(self._latent_dim(), self._disc_units, generator)

  def _make_aux_optimizer(self):
    return torch.optim.Adam(self.aux.parameters(), lr=self._disc_lr,
                            betas=(0.9, 0.999), eps=1e-8)

  def _reduced_z(self, zs: Sequence[torch.Tensor]) -> torch.Tensor:
    zs = [z.reshape(-1, z.shape[-1]) for z in zs]
    if self.reduce_latent == "concat" and len(zs) > 1:
      return torch.cat(zs, -1)
    return zs[0]

  # --------------------------------------------------------------- TC terms
  def _extra_loss(self, out: VAEOutput, batch, training: bool):
    if not training:
      return None
    z = self._reduced_z(out.latent_samples)
    frozen = {k: v.detach() for k, v in self.aux.named_parameters()}
    logits = torch.func.functional_call(self.aux, frozen, (z,))
    tc = PF.batch_mean(logits[:, 0] - logits[:, 1])
    return self.gamma * tc, {"tc": tc}

  def _draw_latents(self, batch, noise=None) -> torch.Tensor:
    """Eval-mode encoder and a fresh reparameterized draw, no gradient."""
    with torch.no_grad():
      self.module.eval()
      qZ = self.module.encode(self._module_input(batch["inputs"]),
                              self.generator)
      return self._reduced_z(self.module._sample(qZ, (), self.generator,
                                                 noise))

  def _disc_loss(self, z: torch.Tensor, perms=None) -> torch.Tensor:
    """The discriminator's loss on joint ``z`` (class 0) against its
    column-permuted copy (class 1)."""
    z_perm = _permute_dims(z, self.generator, perms)
    logp = F.log_softmax(self.aux(torch.cat([z, z_perm])), dim=-1)
    n = z.shape[0]
    return -0.5 * (torch.mean(logp[:n, 0]) + torch.mean(logp[n:, 1]))

  def _disc_update(self, z: torch.Tensor, perms=None) -> torch.Tensor:
    """One Adam step of the discriminator on ``z``; returns the loss
    before the step."""
    loss = self._disc_loss(z, perms)
    self.aux_optimizer.zero_grad(set_to_none=True)
    loss.backward()
    self.aux_optimizer.step()
    return loss.detach()

  def _aux_step(self, batch, metrics: Dict[str, torch.Tensor],
                noise=None, perms=None) -> Dict[str, torch.Tensor]:
    """The discriminator's update after the main step; ``noise`` and
    ``perms`` feed the draw and the permutations (tests). On a data mesh
    z is the global batch's (gathered, detached), so the permutations
    shuffle each column across it, and every rank takes the same step."""
    z = PF.gather_rows(self._draw_latents(batch, noise))
    metrics = dict(metrics)
    metrics["disc_loss"] = self._disc_update(z, perms)
    return metrics

  # ------------------------------------------------- the ensemble's aux step
  def _aux_plan(self, batch, recorder) -> None:
    """Records the discriminator step's draws: the eval-mode latents'
    noise, then the (D, B) column permutations."""
    b, d = self._draw_latents(batch, recorder).shape
    recorder.record(lambda m, gen, params: torch.argsort(
        torch.rand((m, d, b), generator=gen, device=gen.device), dim=-1),
        None)

  def _aux_loss(self, batch, draws) -> torch.Tensor:
    """The discriminator's loss at the updated main parameters, from the
    draws ``_aux_plan`` records (one member's)."""
    return self._disc_loss(self._draw_latents(batch, draws[:-1]), draws[-1])


class SemiFVAE(FVAE):
  """Semi-supervised FactorVAE: TC penalty + masked label heads."""

  mask_outputs = True

  def __init__(self, outputs, **kwargs):
    outputs = _flatten(outputs)
    if len(outputs) < 2:
      raise ValueError("SemiFVAE requires ≥2 outputs (main omic + ≥1 label "
                       f"omic), given {len(outputs)}")
    super().__init__(outputs, **kwargs)
