"""ELBO objective (port of ``sisua_tpu/models/objective.py``).

``ELBO = Σ llkᵢ·maskᵢ − β·KL``, with the main count likelihood routed
through the fused ZINB/NB kernels (``sisua_tpu_torch.ops.zinb``) when
``route_fused_likelihood`` says so. Missing-modality gates (MULTIVI's
mosaic data) multiply each output's row log-likelihoods after the fused
op, and each latent's KL.

Routing (``SISUA_TPU_FUSED_LIKELIHOOD``, the JAX package's variable):
  * 'on'   — always the fused op: its CUDA kernels on a CUDA tensor, its
             plain version (same analytic backward) on a CPU tensor;
  * 'off'  — never: the distribution math under autograd;
  * 'auto' (default) — the fused op exactly when the tensor is on CUDA, at
             every shape the kernels take. The JAX package's 4M-element
             gate (``_PALLAS_MIN_ELEMENTS``) was measured on a TPU and does
             not carry over; a threshold for the card is future work.

bf16-operand mode (``SISUA_TPU_FWD_OPERANDS=bf16``, the JAX package's
variable; default 'f32'): the full (B, D) float32 parameter fields are cast
to bf16 before the fused op (half the bytes the kernels read, and bf16
gradient writes); per-gene rows and the counts ``x`` are not. The cast
happens exactly when the JAX package would cast, ``bf16_operands_ok(B)``
(B a multiple of 16 under the default block): a parity choice, so the same
batch gets the same rounding in both packages; the port's kernels mask
ragged rows and would take any B. A step with MC sample dims
(``mc_samples`` > 1) takes the distribution math in both packages: its
parameters are not one (B, D) matrix.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import torch

from .. import dist as D
from ..ops import zinb as zk
from ..parallel import functional as PF
from .module import VAEOutput

__all__ = ["elbo_terms", "compute_loss", "route_fused_likelihood",
           "mc_row_log_prob"]


def _mode() -> str:
  return os.environ.get("SISUA_TPU_FUSED_LIKELIHOOD", "auto").lower()


def route_fused_likelihood(elements, mode: Optional[str] = None) -> bool:
  """``True`` → the fused op (kernel on CUDA); ``False`` → dist math.

  ``elements`` is the element count of the (B, D) likelihood, the JAX
  form, or the count tensor itself. 'on' and 'off' answer as in JAX. In
  'auto' a tensor routes exactly when it is on CUDA
  (``ops.zinb.kernels_available``), and a count exactly when CUDA is
  available, since the port sends every shape on the card to the kernels.
  The JAX 'auto' answers ``elements >= _PALLAS_MIN_ELEMENTS``, a gate
  measured on a TPU; a threshold for the card is ROADMAP A6's."""
  mode = _mode() if mode is None else mode
  if mode == "on":
    return True
  if mode == "off":
    return False
  if isinstance(elements, torch.Tensor):
    return zk.kernels_available(elements)
  return torch.cuda.is_available()


def _fused_operands(dist: D.Distribution):
  """``(zero_inflated, r, logits, gate, constrained)``: the fused op's
  operands for the four NB kinds (logits / disp / displog / loglog, with
  or without zero-inflation: the 'zinb'/'nb' heads are 'logits') under
  ``Independent`` over genes; None for every other distribution, a
  ``MixtureSameFamily`` head ('mixnb') too, since it is not
  ``Independent``."""
  if not (isinstance(dist, D.Independent)
          and dist.reinterpreted_batch_ndims == 1):
    return None
  base = dist.base
  zi = isinstance(base, D.ZeroInflated)
  count = base.count_distribution if zi else base
  constrained = True
  if isinstance(count, D.NegativeBinomial):
    r, logits = count.total_count, count.logits
  elif isinstance(count, D.NegativeBinomialDisp):
    r = count.disp
    logits = zk._disp_to_logits(count.loc, r)
  elif isinstance(count, D.NegativeBinomialDispLog):
    # log μ is native: logits = log μ − log θ, with a per-gene θ kept a row
    r = count.disp
    logits = count.log_loc - torch.log(r + 1e-8)
  elif isinstance(count, D.NegativeBinomialLog):
    # the kernel reads log θ and exponentiates it (constrained=False). log θ
    # is clipped HERE, once, so logits and θ derive from the same value
    # (a raw-vs-clipped mismatch denormalizes the pmf for |log θ| > 15)
    r = torch.clamp(count.log_disp, -15.0, 15.0)
    logits = count.log_loc - r
    constrained = False
  else:
    return None
  return zi, r, logits, base.gate_logits if zi else None, constrained


def _fused(x, zi, r, logits, gate, constrained):
  if zi:
    return zk.zinb_log_prob_rowsum(x, r, logits, gate,
                                   constrained=constrained)
  return zk.nb_log_prob_rowsum(x, r, logits, constrained=constrained)


def _fast_log_prob(dist: D.Distribution, x: torch.Tensor) -> torch.Tensor:
  """Row-summed log-prob, through the fused op for the four NB kinds
  (``_fused_operands``); everything else takes the distribution math."""
  ops = None
  if (x.ndim == 2
      and len(dist.batch_shape) == 1  # no MC sample dims in the params
      and route_fused_likelihood(x)):
    ops = _fused_operands(dist)
  if ops is None:
    return dist.log_prob(x)
  zi, r, logits, gate, constrained = ops
  if (os.environ.get("SISUA_TPU_FWD_OPERANDS", "f32") == "bf16"
      and zk.bf16_operands_ok(x.shape[0])):
    r, logits, gate = (_bf16_field(a, x) for a in (r, logits, gate))
  return _fused(x, zi, r, logits, gate, constrained)


def mc_row_log_prob(dist: D.Distribution, x: torch.Tensor) -> torch.Tensor:
  """Row-summed log-prob of ``x`` (B, D) under ``dist`` of batch shape
  (S…, B), S… the MC sample dims of a served forward → (S…, B). The four
  NB kinds always take the fused op, whatever the routing variable: the
  S draws are its member axis (``torch.func.vmap``, one launch of the
  forward kernel for all of them on the card, x shared at member stride
  0; the plain version on the CPU). A parameter without the sample dims
  (a per-gene θ) is shared by the draws. Everything else, and an ``x``
  that is not (B, D), takes the distribution math."""
  ops = _fused_operands(dist) if x.ndim == 2 else None
  if ops is None:
    return dist.log_prob(x)
  zi, r, logits, gate, constrained = ops
  mc = tuple(dist.batch_shape[:-1])
  if not mc:
    return _fused(x, zi, r, logits, gate, constrained)
  params, dims = [], []
  for p in (r, logits, gate):
    if isinstance(p, torch.Tensor) and p.ndim > 2:  # has the sample dims
      rows = tuple(p.shape[-2:])
      params.append(p.expand(mc + rows).reshape((-1,) + rows))
      dims.append(0)
    else:
      params.append(p)
      dims.append(None)
  out = torch.func.vmap(
      lambda cr, lg, gt: _fused(x, zi, cr, lg, gt, constrained),
      in_dims=tuple(dims))(*params)
  return out.reshape(mc + tuple(out.shape[1:]))


def _bf16_field(a, x: torch.Tensor):
  """A full (B, D) float32 parameter field as bf16 (the bf16-operand
  mode); a per-gene row, a scalar or None as it is."""
  if (isinstance(a, torch.Tensor) and a.shape == x.shape
      and a.dtype == torch.float32):
    return a.to(torch.bfloat16)
  return a


def _kl_term(q: D.Distribution, prior: Optional[D.Distribution],
             z: torch.Tensor, analytic: bool) -> torch.Tensor:
  """KL(q ‖ prior) per example; Monte-Carlo from the forward sample when
  there is no closed form (or ``analytic=False``)."""
  if prior is None:
    return torch.zeros(q.batch_shape, dtype=z.dtype, device=z.device)
  if analytic:
    try:
      return D.kl_divergence(q, prior)
    except D.NoAnalyticKL:
      pass
  kl = q.log_prob(z) - prior.log_prob(z)
  extra = kl.ndim - len(q.batch_shape)
  if extra > 0:
    kl = kl.mean(dim=tuple(range(extra)))
  return kl


def elbo_terms(out: VAEOutput,
               targets: Sequence[torch.Tensor],
               mask: Optional[torch.Tensor] = None,
               analytic: bool = True,
               mask_outputs: bool = False,
               alpha: float = 1.0,
               mask_renorm: bool = False,
               output_masks: Optional[Sequence[Optional[torch.Tensor]]] = None,
               latent_masks: Optional[Sequence[Optional[torch.Tensor]]] = None,
               ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
  """Per-example log-likelihoods ``llk_<x…>`` and KLs ``klqp_<z…>``.

  ``output_masks``: per-output (B,) gates for cells missing that modality
  (None entries: no gate). Unlike the semi-supervised ``mask`` they gate
  every output, the main one included, after α and the semi-supervised
  mask, in training and evaluation alike. ``latent_masks``: per-latent
  (B,) gates of the KL, for a latent inferred from one modality branch."""
  llk: Dict[str, torch.Tensor] = {}
  for i, (pX, x) in enumerate(zip(out.outputs, targets)):
    name = f"x{i}" if i else "x"
    lp = _fast_log_prob(pX, x)
    extra = lp.ndim - 1  # average over leading MC sample dims
    if extra > 0:
      lp = lp.mean(dim=tuple(range(extra)))
    if i > 0:
      lp = alpha * lp
      if mask_outputs and mask is not None:
        m = mask.to(lp.dtype).reshape(lp.shape[0])
        lp = lp * m
        if mask_renorm:  # the global batch's rows over its labelled count
          lp = lp * (PF.global_rows(m.shape[0])
                     / torch.clamp_min(PF.batch_sum(m), 1.0))
    if output_masks is not None and output_masks[i] is not None:
      lp = lp * output_masks[i].to(lp.dtype).reshape(lp.shape[0])
    llk[f"llk_{name}"] = lp
  kl: Dict[str, torch.Tensor] = {}
  for j, (q, prior, z) in enumerate(
      zip(out.latents, out.priors, out.latent_samples)):
    term = _kl_term(q, prior, z, analytic)
    if latent_masks is not None and j < len(latent_masks) \
        and latent_masks[j] is not None:
      term = term * latent_masks[j].to(term.dtype).reshape(term.shape[0])
    kl[f"klqp_z{j}" if j else "klqp_z"] = term
  return llk, kl


def compute_loss(out: VAEOutput,
                 targets: Sequence[torch.Tensor],
                 mask: Optional[torch.Tensor] = None,
                 beta=1.0,
                 alpha: float = 1.0,
                 analytic: bool = True,
                 mask_outputs: bool = False,
                 mask_renorm: bool = False,
                 output_masks: Optional[Sequence[Optional[torch.Tensor]]]
                 = None,
                 latent_masks: Optional[Sequence[Optional[torch.Tensor]]]
                 = None,
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
  """Scalar −ELBO plus scalar metrics (means over the batch), all tensors
  on the device — nothing here synchronizes with the host. On a data mesh
  the means are the global batch's, in one all-reduce (a rank's gradient
  is its share: ``parallel.functional.batch_means``)."""
  llk, kl = elbo_terms(out, targets, mask=mask, analytic=analytic,
                       mask_outputs=mask_outputs, alpha=alpha,
                       mask_renorm=mask_renorm, output_masks=output_masks,
                       latent_masks=latent_masks)
  elbo = sum(llk.values()) - beta * sum(kl.values())
  terms = {**llk, **kl}
  means = PF.batch_means([elbo, *terms.values()])
  loss = -means[0]
  metrics = dict(zip(terms, means[1:]))
  metrics["loss"] = loss
  metrics["elbo"] = means[0]
  metrics["beta"] = (beta.to(loss.dtype) if isinstance(beta, torch.Tensor)
                     else torch.full((), float(beta), device=loss.device))
  return loss, metrics
