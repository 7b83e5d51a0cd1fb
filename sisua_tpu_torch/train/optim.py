"""optax's optimizers as plain torch (the rest of ``sisua_tpu/train/trainer.py``'s
``make_optimizer``).

``adam`` is ``torch.optim.Adam``, whose update is optax's. The other six
take their update rules and defaults from optax 0.2.6, not from
``torch.optim``, whose rules differ (RMSprop's eps outside the square root,
AdamW's decay scaled by lr·wd inside the step, no Lion or Adafactor):

* ``sgd``: −lr·g (no momentum);
* ``rmsprop``: ν = 0.9·ν + 0.1·g² from ν₀ = 0; −lr·g / √(ν + 1e-8);
* ``adamax``: μ = 0.9·μ + 0.1·g, u = max(|g| + 1e-8, 0.999·u);
  −lr·μ / (1 − 0.9ᵗ) / u;
* ``adamw``: Adam's direction + 1e-4·p (every leaf), times −lr;
* ``lion``: sign(0.1·g + 0.9·μ) + 1e-3·p, times −lr; then
  μ = 0.99·μ + 0.01·g;
* ``adafactor``: optax's ``scale_by_factored_rms`` (decay 1 − (t+1)^−0.8,
  eps 1e-30; a leaf whose two largest dims are ≥ 128 keeps row and column
  second moments, any other leaf a full one), then each leaf's update
  clipped to RMS 1, times lr, times max(RMS(p), 1e-3), negated.

Each holds its state per parameter in a list aligned with ``params`` plus
the step count, with ``state_dict`` / ``load_state_dict`` so a rollback
snapshot restores it. A parameter without a gradient is updated as one
with a zero gradient, as optax sees every leaf.

``clipped_adam_step_`` is the functional, member-stacked form of
``optax.chain(clip_by_global_norm(clipnorm), adam(lr))`` (and of
``inject_hyperparams(adam)`` with one rate per member) that the ensemble
(``train/ensemble.py``) applies to every member at once.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

__all__ = ["OPTIMIZERS", "make_inner_optimizer", "clipped_adam_step_"]


class _OptaxLike:
  """Shared plumbing: ``step`` adds ``_update``'s updates to the params."""

  def __init__(self, params, learning_rate: float):
    self.params = list(params)
    self.lr = float(learning_rate)
    self.count = 0
    self.state: List[Dict[str, torch.Tensor]] = [self._init(p)
                                                 for p in self.params]

  def _init(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
    return {}

  def _update(self, g, p, s) -> torch.Tensor:
    raise NotImplementedError

  @torch.no_grad()
  def step(self) -> None:
    for p, s in zip(self.params, self.state):
      g = p.grad if p.grad is not None else torch.zeros_like(p)
      p.add_(self._update(g, p, s))
    self.count += 1

  def state_dict(self) -> Dict:
    return {"count": self.count, "state": self.state}

  def load_state_dict(self, state: Dict) -> None:
    if len(state["state"]) != len(self.params):
      raise ValueError(f"optimizer state for {len(state['state'])} "
                       f"parameters, this optimizer has {len(self.params)}")
    self.count = int(state["count"])
    self.state = [{k: v.clone() for k, v in s.items()}
                  for s in state["state"]]


def _adam_direction(g, s, t: int, b1=0.9, b2=0.999, eps=1e-8):
  """optax ``scale_by_adam``: updates the moments in ``s`` and returns the
  bias-corrected direction μ̂ / (√ν̂ + eps)."""
  s["mu"] = (1 - b1) * g + b1 * s["mu"]
  s["nu"] = (1 - b2) * g * g + b2 * s["nu"]
  mu_hat = s["mu"] / (1 - b1 ** t)
  nu_hat = s["nu"] / (1 - b2 ** t)
  return mu_hat / (torch.sqrt(nu_hat) + eps)


class SGD(_OptaxLike):
  def _update(self, g, p, s):
    return -self.lr * g


class RMSprop(_OptaxLike):
  decay, eps = 0.9, 1e-8

  def _init(self, p):
    return {"nu": torch.zeros_like(p)}  # initial_scale 0

  def _update(self, g, p, s):
    s["nu"] = (1 - self.decay) * g * g + self.decay * s["nu"]
    return -self.lr * (torch.rsqrt(s["nu"] + self.eps) * g)


class Adamax(_OptaxLike):
  b1, b2, eps = 0.9, 0.999, 1e-8

  def _init(self, p):
    return {"mu": torch.zeros_like(p), "nu": torch.zeros_like(p)}

  def _update(self, g, p, s):
    s["mu"] = (1 - self.b1) * g + self.b1 * s["mu"]
    s["nu"] = torch.maximum(torch.abs(g) + self.eps, self.b2 * s["nu"])
    mu_hat = s["mu"] / (1 - self.b1 ** (self.count + 1))
    return -self.lr * (mu_hat / s["nu"])


class AdamW(_OptaxLike):
  weight_decay = 1e-4

  def _init(self, p):
    return {"mu": torch.zeros_like(p), "nu": torch.zeros_like(p)}

  def _update(self, g, p, s):
    u = _adam_direction(g, s, self.count + 1)
    return -self.lr * (u + self.weight_decay * p)


class Lion(_OptaxLike):
  b1, b2, weight_decay = 0.9, 0.99, 1e-3

  def _init(self, p):
    return {"mu": torch.zeros_like(p)}

  def _update(self, g, p, s):
    u = torch.sign((1 - self.b1) * g + self.b1 * s["mu"])
    s["mu"] = (1 - self.b2) * g + self.b2 * s["mu"]
    return -self.lr * (u + self.weight_decay * p)


def _factored_dims(shape, min_dim: int = 128):
  """optax ``_factored_dims``: (d1, d0), the second largest and the largest
  dim, when the second largest is ≥ ``min_dim``; else None."""
  if len(shape) < 2:
    return None
  order = np.argsort(shape)
  if shape[order[-2]] < min_dim:
    return None
  return int(order[-2]), int(order[-1])


def _rms(x: torch.Tensor) -> torch.Tensor:
  return torch.sqrt(torch.mean(x * x))


class Adafactor(_OptaxLike):
  decay_rate, eps, clipping_threshold, min_scale = 0.8, 1e-30, 1.0, 1e-3

  def _init(self, p):
    dims = _factored_dims(tuple(p.shape))
    if dims is None:
      return {"v": torch.zeros_like(p)}
    d1, d0 = dims
    return {"v_row": torch.zeros_like(p.sum(dim=d0)),
            "v_col": torch.zeros_like(p.sum(dim=d1))}

  def _update(self, g, p, s):
    decay = 1.0 - float(self.count + 1) ** -self.decay_rate
    g2 = g * g + self.eps
    dims = _factored_dims(tuple(p.shape))
    if dims is None:
      s["v"] = decay * s["v"] + (1 - decay) * g2
      u = g * s["v"] ** -0.5
    else:
      d1, d0 = dims
      s["v_row"] = decay * s["v_row"] + (1 - decay) * g2.mean(dim=d0)
      s["v_col"] = decay * s["v_col"] + (1 - decay) * g2.mean(dim=d1)
      rd1 = d1 - 1 if d1 > d0 else d1
      row = (s["v_row"] / s["v_row"].mean(dim=rd1, keepdim=True)) ** -0.5
      col = s["v_col"] ** -0.5
      u = g * row.unsqueeze(d0) * col.unsqueeze(d1)
    u = u / torch.clamp_min(_rms(u) / self.clipping_threshold, 1.0)
    u = u * self.lr
    # optax safe_root_mean_squares: the RMS floored at min_scale
    rms = _rms(p)
    u = u * torch.where(rms <= self.min_scale,
                        torch.full_like(rms, self.min_scale), rms)
    return -u


OPTIMIZERS = {"sgd": SGD, "rmsprop": RMSprop, "adamax": Adamax,
              "adamw": AdamW, "lion": Lion, "adafactor": Adafactor}


def make_inner_optimizer(name: str, params, learning_rate: float):
  """The optimizer ``name`` (the JAX trainer's names) over ``params``."""
  if name == "adam":
    # optax's Adam (eps=1e-8, eps_root=0) is torch.optim.Adam's update
    return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999),
                            eps=1e-8)
  return OPTIMIZERS[name](params, learning_rate)


def _per_member(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
  """An (M,) tensor shaped to broadcast over ``like``'s member axis."""
  return v.reshape(-1, *([1] * (like.dim() - 1)))


def _member_global_norms(grads) -> torch.Tensor:
  """optax ``global_norm`` of each member: every tensor of ``grads`` has
  the member axis first; returns (M,)."""
  sums = [torch.sum(g * g, dim=tuple(range(1, g.dim()))) for g in grads]
  return torch.sqrt(torch.stack(sums).sum(0))


@torch.no_grad()
def clipped_adam_step_(params, grads, mu, nu, count: torch.Tensor, lr,
                       clipnorm: float, b1: float = 0.9, b2: float = 0.999,
                       eps: float = 1e-8) -> torch.Tensor:
  """One step of ``optax.chain(clip_by_global_norm(clipnorm), adam(lr))``
  on stacked members, in place: ``params``, ``grads``, ``mu`` and ``nu``
  are aligned lists of tensors with the member axis first, ``count`` the
  (M,) step counts, ``lr`` a float or an (M,) tensor of rates (optax's
  ``inject_hyperparams``). The clip's global norm is each member's own
  (no clip when ``clipnorm`` is 0). optax's arithmetic, element for
  element: μ = (1−b1)·g + b1·μ, ν = (1−b2)·g² + b2·ν, then
  −lr · μ̂ / (√ν̂ + eps) with bias corrections 1 − bᵗ. Returns the
  pre-clip norms (M,)."""
  norms = _member_global_norms(grads)
  if clipnorm > 0:
    keep = norms < clipnorm
    grads = [torch.where(_per_member(keep, g), g,
                         g / _per_member(norms, g) * clipnorm)
             for g in grads]
  torch._foreach_mul_(mu, b1)
  torch._foreach_add_(mu, torch._foreach_mul(grads, 1.0 - b1))
  sq = torch._foreach_mul(grads, grads)
  torch._foreach_mul_(sq, 1.0 - b2)
  torch._foreach_mul_(nu, b2)
  torch._foreach_add_(nu, sq)
  count += 1
  t = count.to(torch.float32)
  bc1 = 1.0 - torch.pow(b1, t)
  bc2 = 1.0 - torch.pow(b2, t)
  neg_lr = -(lr if isinstance(lr, torch.Tensor) else torch.full_like(t, lr))
  for p, m, v in zip(params, mu, nu):
    u = (m / _per_member(bc1, m)) / (torch.sqrt(v / _per_member(bc2, v))
                                     + eps)
    p.add_(u * _per_member(neg_lr, u))
  return norms
