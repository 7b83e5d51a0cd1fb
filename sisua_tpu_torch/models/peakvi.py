"""PeakVI — variational inference for single-cell chromatin accessibility
(Ashuach et al. 2022, scvi-tools ``PEAKVI``), port of
``sisua_tpu/models/peakvi.py``.

  * accessibility is binarized (x > 0): the encoder input and the
    likelihood target;
  * per-cell-per-peak Bernoulli with p = σ(ℓ_y)·σ(ℓ_d)·σ(ρ): ℓ_y from the
    decoder (``AccessibilityScale``), ℓ_d a per-cell depth logit from its
    own encoder on the binarized peaks (``depth_encoder`` → ``depth_head``),
    ρ a per-peak region factor that starts at zero;
  * standard normal latent prior, analytic KL.

The three factors compose in log space and convert to one Bernoulli logit
(``_compose_logits``), as the JAX package does in XLA; plain torch here
too, no kernel. As in the JAX module, the method is ``depth_logit`` and
the Dense layer the attribute ``depth_head``, whose parameters flax (and
so every checkpoint) keys ``depth_logit``: ``flax_names`` tells
``convert`` so.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..nn import NetConf, dense, parse_netconf
from ..rv import parse_rv
from .base import SingleCellModel, _flatten
from .module import VAEModule, VAEOutput

__all__ = ["PEAKVI", "PEAKVIModule"]

# log p ≤ −1e-7 keeps 1 − p > 0 (bit-equal with the JAX package)
_LOG_P_MAX = -1e-7


def _compose_logits(ly: torch.Tensor, ld: Optional[torch.Tensor],
                    lr: Optional[torch.Tensor]) -> torch.Tensor:
  """Bernoulli logit of p = σ(ly)·σ(ld)·σ(lr) (a missing factor is 1): log p
  sums log-sigmoids, in the JAX package's order; log(1 − p) comes from
  expm1."""
  log_p = F.logsigmoid(ly)
  if ld is not None:
    log_p = log_p + F.logsigmoid(ld)
  if lr is not None:
    log_p = log_p + F.logsigmoid(lr)
  log_p = torch.clamp_max(log_p, _LOG_P_MAX)
  return log_p - torch.log(-torch.expm1(log_p))


def _binarized(x: torch.Tensor) -> torch.Tensor:
  return (x > 0).to(torch.float32)


class PEAKVIModule(VAEModule):
  """The VAE engine with a binarizing ``preprocess``, the depth encoder, the
  per-peak region factor and the composed Bernoulli decode."""

  #: torch submodule name → its flax name (``convert`` maps them)
  flax_names = {"depth_head": "depth_logit"}

  def __init__(self, outputs, latents, encoder_confs, decoder_confs,
               log_norm: bool = False, reduce_latent: str = "concat",
               depth_conf: Optional[NetConf] = None, n_batch: int = 0,
               generator: Optional[torch.Generator] = None):
    super().__init__(outputs, latents, encoder_confs, decoder_confs,
                     log_norm=log_norm, reduce_latent=reduce_latent,
                     n_batch=n_batch, generator=generator)
    R = self.outputs[0].dim
    self.region_factor = nn.Parameter(torch.zeros(R))
    # the depth encoder reads the binarized peaks without the batch block
    self.depth_encoder = depth_conf.build(R, generator)
    self.depth_head = dense(self.depth_encoder.out_dim, 1, generator)
    self.AccessibilityScale = dense(self.decoders[0].out_dim, R, generator)

  def preprocess(self, x):
    return _binarized(x)

  def depth_logit(self, x, generator=None) -> torch.Tensor:
    """ℓ_d, (…, 1), through ``depth_head``."""
    xb, _ = self.split_batch(x)
    return self.depth_head(self.depth_encoder(self.preprocess(xb),
                                               generator))

  def decode(self, z, library=None, generator=None, batch=None,
             depth_logit: Optional[torch.Tensor] = None,
             region: bool = True):
    """``depth_logit=None`` (a user's decode) drops the depth factor: the
    depth-free accessibility estimate; ``region=False`` drops the per-peak
    factor too."""
    h = self.decoders[0](self._decoder_input(z, batch), generator)
    logits = _compose_logits(self.AccessibilityScale(h), depth_logit,
                             self.region_factor if region else None)
    return (self.output_heads[0](logits),) + tuple(
        head(h) for head in self.output_heads[1:])

  def forward(self, x, library=None, sample_shape=(), generator=None,
              noise=None) -> VAEOutput:
    _, b = self.split_batch(x)
    qZ = self.encode(x, generator)
    zs = self._sample(qZ, sample_shape, generator, noise)
    pX = self.decode(self.reduce_latents(zs), library, generator, b,
                     depth_logit=self.depth_logit(x, generator))
    return VAEOutput(outputs=pX, latents=qZ, latent_samples=zs,
                     priors=self.latent_priors(library, like=x))


class PEAKVI(SingleCellModel):
  """Chromatin-accessibility VAE (scvi-tools ``PEAKVI`` surface).

  ``outputs[0]`` is coerced to a 'bernoulli' likelihood over peaks with
  ``projection=False``; raw fragment counts are accepted, since the model
  binarizes the encoder input and the likelihood target
  (``_loss_targets``). ``log_norm`` defaults to False."""

  module_cls = PEAKVIModule

  def __init__(self, outputs, depth=None, **kwargs):
    outputs = [parse_rv(o, f"output{i}")
               for i, o in enumerate(_flatten(outputs))]
    outputs[0] = outputs[0].replace(posterior="bernoulli", projection=False,
                                    kwargs=())
    kwargs.setdefault("log_norm", False)
    if depth is None:
      depth = kwargs.pop("depth_conf", NetConf((32,), name="depth"))
    super().__init__(outputs, depth_conf=parse_netconf(depth, "depth"),
                     **kwargs)

  def _loss_targets(self, batch):
    targets = list(batch["inputs"])
    targets[0] = _binarized(targets[0])
    return targets

  def get_accessibility_estimates(self, data, batch_size: int = 256,
                                  region: bool = True) -> np.ndarray:
    """Depth-free accessibility probabilities σ(ℓ_y)·σ(ρ) (σ(ℓ_y) alone with
    ``region=False``) at the posterior mean of z, (n, peaks)."""
    _, qZ = self.predict(data, batch_size=batch_size)
    qz = qZ[0] if isinstance(qZ, tuple) else qZ
    return _decoded_probs(self, qz.mean(), 0, region)


def _decoded_probs(model: SingleCellModel, z, index: int,
                   region: bool) -> np.ndarray:
  """Output ``index``'s mean of an eval-mode decode at latent means ``z``
  (a tensor, or MULTIVI's (z, l)), without the depth factor, on the host."""
  zs = tuple(t.to(model.device) for t in _flatten(z))
  model.module.eval()
  with torch.no_grad():
    out = model.module.decode(zs if len(zs) > 1 else zs[0], region=region)
    return out[index].mean().cpu().numpy()
