"""Vmapped model ensembles: N members of one class trained at once on the
card (port of ``sisua_tpu/train/ensemble.py``).

The reference trains one process per model. The JAX package stacks the
members' states and ``jax.vmap``s one train step over the member axis;
here ``torch.func.vmap`` of ``torch.func.grad_and_value`` over
``torch.func.functional_call`` does the same over stacked parameters and
buffers. Each batch is read once for every member (``shared_batches``),
the MLP products batch over members, and both ZINB kernels take the
members on one launch each (``ops/zinb.py``: the member axis is grid z).

What the transform changes, and how the port deals with it:

* A ``torch.Generator`` draw cannot run inside ``vmap``. Each step's
  reparameterization noise (one standard-normal tensor per latent) and
  dropout keep-masks are drawn outside the transform as (M, …) tensors
  from the ensemble's generator and fed in (``noise=``, ``DropoutMasks``).
  Their shapes come from one forward of the template model outside the
  transform at the start of each ``fit`` (``_draw_plan``).
* BatchNorm updates its running statistics in place; under
  ``functional_call`` the stacked (M, F) buffers are what it updates.
* The optimizer is the JAX ensemble's own: ``optax.chain(
  clip_by_global_norm(clipnorm), adam(lr))``, or ``inject_hyperparams``
  Adam with one rate per member, as ``optim.clipped_adam_step_`` on the
  stacked tensors, with each member's own global norm.

Use:
    ens = VmapEnsemble(lambda seed: SCVI(..., seed=seed), n_models=4)
    ens.fit(x, epochs=50, batch_size=512)
    losses = ens.history["loss"]          # (epochs, n_models)
    best = ens.best()                     # a standalone trained model

Not batched yet, and raising ``NotImplementedError`` (ROADMAP A19b): a
class with an auxiliary step (FVAE/SemiFVAE's discriminator), a mixture
latent (SCALE/SCALAR: the component index depends on the forward), and a
forward that draws beyond its latents' noise and dropout (TotalVI's
log β, SCANVI's z₂, AUTOZI's δ). ``mesh=`` raises too (ROADMAP A21).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from .. import dist as D
from ..nn import DropoutMasks
from .optim import clipped_adam_step_
from .trainer import ClippedAdam, Trainer

__all__ = ["VmapEnsemble"]

# the JAX ensemble's training key, jax.random.key(17)
_SEED = 17


class _MemberLoss(nn.Module):
  """The template model's training loss as a module whose state is the
  template's ``module`` (keys ``module.<name>``), for ``functional_call``."""

  def __init__(self, model):
    super().__init__()
    self.module = model.module
    self._model = [model]  # a plain list: not a submodule

  def forward(self, batch, beta, noise, masks):
    return self._model[0]._loss(batch, True, beta, noise=noise,
                                masks=DropoutMasks(masks))


_BEYOND = ("'s forward draws beyond its latents' noise and dropout; the "
           "ensemble cannot feed it yet (ROADMAP A19b)")


class _LatentNoise(list):
  """The draw plan's noise, one entry per latent: a forward that asks for
  an entry past them (TotalVI's log β, SCANVI's z₂, AUTOZI's δ) raises."""

  def __init__(self, entries, owner: str):
    super().__init__(entries)
    self.owner = owner

  def __getitem__(self, i):
    start = (i.start or 0) if isinstance(i, slice) else i
    if start >= len(self):
      raise NotImplementedError(self.owner + _BEYOND)
    return super().__getitem__(i)


class VmapEnsemble:

  def __init__(self, model_fn: Callable[[int], "SingleCellModel"],
               n_models: int = 4, base_seed: int = 0):
    self.n_models = int(n_models)
    self.models = [model_fn(base_seed + i) for i in range(self.n_models)]
    m0 = self.models[0]
    for m in self.models[1:]:
      if type(m) is not type(m0):
        raise TypeError("ensemble members must share the class")
    self.model = m0  # structural template
    self.history: Dict[str, np.ndarray] = {}
    self._stacked: Optional[Dict] = None
    self.generator = torch.Generator(device=m0.device).manual_seed(_SEED)

  # ------------------------------------------------------------------ state
  def _stack_states(self) -> Dict:
    """The members' parameters and buffers stacked on a leading member
    axis, fresh Adam moments and counts, and each member's step."""
    mods = [m.module for m in self.models]
    params = {k: torch.stack([dict(md.named_parameters())[k].detach()
                              for md in mods])
              for k, _ in mods[0].named_parameters()}
    buffers = {k: torch.stack([dict(md.named_buffers())[k] for md in mods])
               for k, _ in mods[0].named_buffers()}
    dev = self.model.device
    return {"params": params, "buffers": buffers,
            "mu": {k: torch.zeros_like(v) for k, v in params.items()},
            "nu": {k: torch.zeros_like(v) for k, v in params.items()},
            "count": torch.zeros((self.n_models,), dtype=torch.int32,
                                 device=dev),
            "steps": [int(m.step) for m in self.models]}

  def _write_back(self, lrs, clipnorm: float) -> None:
    """Each member's parameters, buffers and step into its model, and its
    Adam moments into the model's optimizer (a later ``fit`` carries them
    over, as the JAX ``fit`` keeps the member's ``opt_state``)."""
    st = self._stacked
    counts = st["count"].cpu().tolist()
    with torch.no_grad():
      for i, m in enumerate(self.models):
        named = dict(m.module.named_parameters())
        for k, p in named.items():
          p.copy_(st["params"][k][i])
        for k, b in m.module.named_buffers():
          b.copy_(st["buffers"][k][i])
        m.step = st["steps"][i]
        opt = ClippedAdam(named.values(), lrs[i], clipnorm)
        for k, p in named.items():
          opt.inner.state[p] = {"step": torch.tensor(float(counts[i])),
                                "exp_avg": st["mu"][k][i].clone(),
                                "exp_avg_sq": st["nu"][k][i].clone()}
        m.optimizer, m._last_freeze = opt, ()

  # -------------------------------------------------------------- the step
  def _check_supported(self) -> None:
    model = self.model
    if model.aux is not None:
      raise NotImplementedError(
          f"{type(model).__name__}'s auxiliary step (its discriminator) is "
          "not batched over ensemble members yet (ROADMAP A19b)")

  def _draw_plan(self, batch):
    """The shapes of one member's draws for a batch like ``batch``: each
    latent's standard noise (None for a deterministic latent) and each
    dropout mask with its keep probability, from one forward of the
    template model's module outside the transform (its running stats
    kept; no likelihood, so no kernel launch)."""
    model = self.model
    model.module.train(True)
    with torch.no_grad(), model._batch_stats_kept(True):
      x = model._masked_module_input(batch, True)
      shapes = []
      for q in model.module.encode(x, DropoutMasks()):
        if isinstance(q, D.MixtureSameFamily):
          raise NotImplementedError(
              f"{type(model).__name__}'s mixture latent draws its component "
              "from the forward; the ensemble cannot feed it yet (ROADMAP "
              "A19b)")
        shapes.append(None if isinstance(q, D.VectorDeterministic)
                      else tuple(q.batch_shape) + tuple(q.event_shape))
      masks = DropoutMasks()
      noise = _LatentNoise([None if s is None else
                            torch.zeros(s, device=x.device) for s in shapes],
                           type(model).__name__)
      library = batch.get("library") if model.uses_library else None
      try:
        model.module(x, library=library, generator=masks, noise=noise)
      except TypeError as e:  # a torch draw handed DropoutMasks
        raise NotImplementedError(type(model).__name__ + _BEYOND) from e
    return shapes, masks.specs

  def _draws(self, plan):
    """One fleet step's noise and dropout masks, (M, …) each."""
    shapes, mask_specs = plan
    gen, m, dev = self.generator, self.n_models, self.model.device
    noise = [None if s is None else
             torch.randn((m, *s), generator=gen, device=dev) for s in shapes]
    masks = [torch.rand((m, *s), generator=gen, device=dev) < keep
             for s, keep in mask_specs]
    return noise, masks

  def _make_step(self, shared: bool, has_library: bool, plan):
    """The vmapped gradient of one member's loss: (params, buffers,
    inputs, mask, library, noise, masks, beta) → (grads, (loss,
    metrics)), every output with the member axis first."""
    loss_module = _MemberLoss(self.model)

    def member_loss(params, buffers, inputs, mask, library, noise, masks,
                    beta):
      batch = {"inputs": list(inputs), "mask": mask}
      if library is not None:
        batch["library"] = library
      state = {f"module.{k}": v for k, v in params.items()}
      state.update({f"module.{k}": v for k, v in buffers.items()})
      loss, metrics, _ = torch.func.functional_call(
          loss_module, state, (batch, beta, noise, masks))
      return loss, metrics

    x_dim = None if shared else 0
    noise_dims = [None if s is None else 0 for s in plan[0]]
    beta_dim = None if isinstance(self._beta([0]), float) else 0
    return torch.func.vmap(
        torch.func.grad_and_value(member_loss, has_aux=True),
        in_dims=(0, 0, x_dim, x_dim, x_dim if has_library else None,
                 noise_dims, 0, beta_dim))

  def _train_step(self, step_fn, batch, noise, masks, lr, clipnorm: float):
    """One fleet step on the stacked state: every member's gradient in one
    vmapped call, then the stacked clipped Adam. Returns the (M,) losses,
    the metrics and the pre-clip gradients, on the card."""
    st = self._stacked
    keys = list(st["params"])
    grads, (loss, metrics) = step_fn(
        st["params"], st["buffers"], batch["inputs"], batch["mask"],
        batch.get("library"), noise, masks, self._beta(st["steps"]))
    clipped_adam_step_([st["params"][k] for k in keys],
                       [grads[k] for k in keys], [st["mu"][k] for k in keys],
                       [st["nu"][k] for k in keys], st["count"], lr, clipnorm)
    st["steps"] = [s + 1 for s in st["steps"]]
    return loss.detach(), metrics, grads

  def _beta(self, steps):
    """β of every member at its step: one float for a constant schedule,
    else an (M,) tensor (the JAX step computes β from each member's
    ``state.step``)."""
    sched = self.model.beta
    if sched.kind == "const" and not sched.cyclical:
      return float(sched(0))
    return torch.tensor([sched(s) for s in steps], dtype=torch.float32,
                        device=self.model.device)

  # -------------------------------------------------------------------- fit
  def fit(self,
          train,
          epochs: int = 100,
          batch_size: int = 64,
          learning_rate=1e-3,
          clipnorm: float = 100.0,
          labels_percent: float = 0.0,
          shared_batches: bool = True,
          metrics_interval: int = 1,
          mesh=None,
          verbose: bool = False) -> "VmapEnsemble":
    """Device-resident ensemble training, the JAX ``VmapEnsemble.fit``:
    the data on the card once for every member; epochs of ``n //
    batch_size`` steps over a fresh permutation, and a fresh
    semi-supervised mask (``labels_percent``) per epoch;
    ``shared_batches=True`` feeds every member the same batches, False
    gives each member its own permutation and mask. ``learning_rate`` is
    one float, or one rate per member. ``metrics_interval=K``: the (M,)
    epoch losses stay on the card and are fetched once per window of K
    epochs. ``history['loss']`` is (epochs, M). The stacked state is kept
    between calls; each member's state is written back into its model."""
    if mesh is not None:
      raise NotImplementedError("mesh training of an ensemble is not "
                                "ported yet (ROADMAP A21)")
    self._check_supported()
    model = self.model
    if not model.is_semi_supervised:
      labels_percent = 0.0
    m_count = self.n_models
    if isinstance(learning_rate, (tuple, list, np.ndarray)):
      lrs = [float(v) for v in learning_rate]
      if len(lrs) != m_count:
        raise ValueError(f"got {len(lrs)} learning rates for {m_count} "
                         "members")
      lr = torch.tensor(lrs, dtype=torch.float32, device=model.device)
    else:
      lrs = [float(learning_rate)] * m_count
      lr = lrs[0]
    feeder = model._to_feeder(train, batch_size, labels_percent)
    n, B = feeder.n_obs, int(batch_size)
    if n < B:
      raise ValueError(f"VmapEnsemble needs at least one full batch: {n} "
                       f"cells < batch_size {B}")
    dev = model.device
    placer = Trainer(device=dev)
    xs = [placer._resident_matrix(src, dev) for src in feeder.sources]
    library = (torch.as_tensor(feeder.library, dtype=torch.float32,
                               device=dev)
               if feeder.library is not None else None)
    if self._stacked is None:
      self._stacked = self._stack_states()
    st = self._stacked
    lp, gen = float(labels_percent), self.generator
    steps = n // B

    def take(t, rows):  # shared rows (B,), or (M, B) per member
      return t.index_select(0, rows) if rows.dim() == 1 else t[rows]

    def batch_at(rows, mask_all):
      mask = (mask_all.index_select(0, rows) if rows.dim() == 1
              else torch.gather(mask_all, 1, rows))
      b = {"inputs": [take(x, rows) for x in xs], "mask": mask}
      if library is not None:
        b["library"] = take(library, rows)
      return b

    plan, step_fn = None, None
    interval = max(1, int(metrics_interval))
    losses: List[np.ndarray] = []
    times: List[float] = []
    done = 0
    while done < epochs:
      window = min(interval, epochs - done)
      t0 = time.perf_counter()
      win = []
      for _ in range(window):
        if shared_batches:
          perm = torch.randperm(n, generator=gen, device=dev)
          mask_all = (torch.rand((n,), generator=gen, device=dev)
                      < lp).to(torch.float32)
        else:
          perm = torch.argsort(torch.rand((m_count, n), generator=gen,
                                          device=dev), dim=1)
          mask_all = (torch.rand((m_count, n), generator=gen, device=dev)
                      < lp).to(torch.float32)
        loss_sum = torch.zeros((m_count,), device=dev)
        for i in range(steps):
          rows = perm[..., i * B:(i + 1) * B]
          batch = batch_at(rows, mask_all)
          if plan is None:
            one = (batch if shared_batches else
                   {k: ([t[0] for t in v] if k == "inputs" else v[0])
                    for k, v in batch.items()})
            plan = self._draw_plan(one)
          if step_fn is None:
            step_fn = self._make_step(shared_batches, library is not None,
                                      plan)
          loss = self._train_step(step_fn, batch, *self._draws(plan), lr,
                                  float(clipnorm or 0.0))[0]
          loss_sum += loss
        win.append(loss_sum / steps)
      win_losses = torch.stack(win, 1).cpu().numpy()  # (M, E): one fetch
      dt = (time.perf_counter() - t0) / window
      for e in range(window):
        losses.append(win_losses[:, e])
        times.append(dt)
        if verbose:
          print(f"[ensemble epoch {done + e:03d}] "
                f"loss={np.round(losses[-1], 2)} ({dt:.3f}s)")
      done += window
    self.history["loss"] = np.stack(losses)       # (epochs, n_models)
    self.history["epoch_time"] = np.asarray(times)
    self._write_back(lrs, float(clipnorm or 0.0))
    return self

  def extract(self, index: int):
    """Member ``index`` as a standalone trained model."""
    return self.models[index]

  def best(self):
    if "loss" not in self.history:
      raise RuntimeError("fit the ensemble first")
    return self.extract(int(np.argmin(self.history["loss"][-1])))
