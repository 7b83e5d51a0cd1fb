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

* A ``torch.Generator`` draw cannot run inside ``vmap``. Every draw of a
  step is made outside the transform as (M, …) tensors from the
  ensemble's generator and fed in: the forward's noise entries
  (``noise=``) and dropout keep-masks (``DropoutMasks``). Which draws a
  forward makes is learnt at the start of each ``fit`` from one forward
  of the template model handed a ``NoiseRecorder`` (``_draw_plan``):
  each latent's standard noise; a mixture latent's Gumbel noise and
  component noise (SCALE/SCALAR: the component index is
  ``argmax(logits + Gumbel)`` inside the transform, as
  ``jax.random.categorical``); TotalVI's log β and SCANVI's z₂ noise;
  AUTOZI's δ pair, drawn from each member's own α, β; MULTIVI's (z, l).
* FVAE/SemiFVAE's discriminator step, after the main one: each member's
  TC term reads its own discriminator (detached), then a second vmapped
  gradient over the stacked discriminators, at the updated parameters
  and running statistics with fresh eval-mode noise and column
  permutations, and one unclipped Adam step of ``discriminator_lr``
  with its own count, as the JAX step's ``_aux_step``.
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

Every class of ``get_all_models()`` trains as a fleet. ``mesh=`` splits the
members over the world's ranks, as the JAX ensemble shards its member axis
over every device: rank r trains members [r·M/W, (r+1)·M/W) with no
collective in the step. Every rank makes the whole fleet's draws from the
same generator and keeps its members' (AUTOZI's δ reads every member's α,
β: gathered for it), so member i trains as in the unsharded fleet; the
states and histories are all-gathered at the end.

AUTOZI's Beta KL is scaled by ``n_total_cells`` as the template has it
(10,000 when unset), as the JAX ensemble, which never calls AUTOZI's
``fit``.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from ..models.module import NoiseRecorder
from ..nn import DropoutMasks
from ..parallel import functional as PF
from ..parallel.mesh import DATA_AXIS, MODEL_AXIS, axis_size
from .optim import clipped_adam_step_
from .trainer import ClippedAdam, Trainer

__all__ = ["VmapEnsemble"]

# the JAX ensemble's training key, jax.random.key(17)
_SEED = 17


class _Member(nn.Module):
  """The template model's module (keys ``module.<name>``) and aux group
  (``aux.<name>``) as one module for ``functional_call``: a member's
  stacked state swaps in for both."""

  def __init__(self, model):
    super().__init__()
    self.module = model.module
    if model.aux is not None:
      self.aux = model.aux
    self._model = [model]  # a plain list: not a submodule


class _MemberLoss(_Member):
  """The training loss; FactorVAE's TC term reads the member's own
  discriminator (its ``aux.*``, fed detached)."""

  def forward(self, batch, beta, noise, masks):
    return self._model[0]._loss(batch, True, beta, noise=noise,
                                masks=DropoutMasks(masks))


class _MemberAuxLoss(_Member):
  """The aux step's loss (FactorVAE's discriminator)."""

  def forward(self, batch, draws):
    return self._model[0]._aux_loss(batch, draws)


class _Plan(NamedTuple):
  """One member's draws a fleet step makes, learnt from the template."""
  noise: List   # the forward's noise entries: NoiseRecorder draw functions
  masks: List   # (shape, keep probability) of each dropout mask
  aux: Optional[List]  # the aux step's draws, or None without one


def _gathered_members(tree):
  """A stacked state (dicts of (m, …) tensors, the members' step list)
  with every rank's members, in rank order."""
  if isinstance(tree, dict):
    return {k: _gathered_members(v) for k, v in tree.items()}
  if isinstance(tree, list):
    parts = [None] * torch.distributed.get_world_size()
    torch.distributed.all_gather_object(parts, tree)
    return [s for part in parts for s in part]
  return PF.all_gather_cat(tree, None, 0)


def _member_rows(tree, lo: int, hi: int):
  """Members [lo, hi) of a stacked state."""
  if isinstance(tree, dict):
    return {k: _member_rows(v, lo, hi) for k, v in tree.items()}
  if isinstance(tree, list):
    return tree[lo:hi]
  return tree[lo:hi].clone()


class _FleetParams(dict):
  """The stacked parameters a draw reads (AUTOZI's δ), every member's:
  each is gathered over the world when a draw asks for it."""

  def __init__(self, local):
    super().__init__()
    self._local = local

  def __getitem__(self, key):
    if key not in self:
      self[key] = PF.all_gather_cat(self._local[key], None, 0)
    return super().__getitem__(key)


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
    #: this rank's members [lo, hi) in a mesh fit, else all of them
    self._rows = (0, self.n_models)

  # ------------------------------------------------------------------ state
  def _stack_states(self) -> Dict:
    """The members' parameters and buffers stacked on a leading member
    axis, fresh Adam moments and counts, and each member's step; with an
    aux group, the same for it under ``aux`` (its own Adam count)."""
    dev = self.model.device

    def stacked(mods):
      params = {k: torch.stack([dict(md.named_parameters())[k].detach()
                                for md in mods])
                for k, _ in mods[0].named_parameters()}
      return {"params": params,
              "buffers": {k: torch.stack([dict(md.named_buffers())[k]
                                          for md in mods])
                          for k, _ in mods[0].named_buffers()},
              "mu": {k: torch.zeros_like(v) for k, v in params.items()},
              "nu": {k: torch.zeros_like(v) for k, v in params.items()},
              "count": torch.zeros((self.n_models,), dtype=torch.int32,
                                   device=dev)}
    st = stacked([m.module for m in self.models])
    st["steps"] = [int(m.step) for m in self.models]
    if self.model.aux is not None:
      st["aux"] = stacked([m.aux for m in self.models])
    return st

  @staticmethod
  def _adam_state(opt, named, st, i: int, count: int) -> None:
    """Member ``i``'s moments and count as ``opt``'s (a torch Adam)."""
    for k, p in named.items():
      opt.state[p] = {"step": torch.tensor(float(count)),
                      "exp_avg": st["mu"][k][i].clone(),
                      "exp_avg_sq": st["nu"][k][i].clone()}

  def _write_back(self, lrs, clipnorm: float) -> None:
    """Each member's parameters, buffers and step into its model, and its
    Adam moments into the model's optimizer (a later ``fit`` carries them
    over, as the JAX ``fit`` keeps the member's ``opt_state``); the aux
    parameters into its ``aux``, their moments and count into its
    ``aux_optimizer``."""
    st = self._stacked
    counts = st["count"].cpu().tolist()
    aux = st.get("aux")
    aux_counts = None if aux is None else aux["count"].cpu().tolist()
    with torch.no_grad():
      for i, m in enumerate(self.models):
        named = dict(m.module.named_parameters())
        for k, p in named.items():
          p.copy_(st["params"][k][i])
        for k, b in m.module.named_buffers():
          b.copy_(st["buffers"][k][i])
        m.step = st["steps"][i]
        opt = ClippedAdam(named.values(), lrs[i], clipnorm)
        self._adam_state(opt.inner, named, st, i, counts[i])
        m.optimizer, m._last_freeze = opt, ()
        if aux is not None:
          named = dict(m.aux.named_parameters())
          for k, p in named.items():
            p.copy_(aux["params"][k][i])
          m.aux_optimizer = m._make_aux_optimizer()
          self._adam_state(m.aux_optimizer, named, aux, i, aux_counts[i])

  # -------------------------------------------------------------- the step
  def _member_split(self, mesh):
    """This rank's members [lo, hi) over the mesh's ranks (the JAX
    assertion when they do not divide), or all of them."""
    if mesh is None:
      return 0, self.n_models
    n_dev = axis_size(mesh, DATA_AXIS) * axis_size(mesh, MODEL_AXIS)
    assert self.n_models % n_dev == 0, (
        f"n_models {self.n_models} must divide evenly over the "
        f"{n_dev}-device mesh (each chip trains n_models/n_devices "
        "members)")
    per = self.n_models // n_dev
    r = torch.distributed.get_rank()
    return r * per, (r + 1) * per

  def _draw_plan(self, batch) -> _Plan:
    """The draws of one member's step on a batch like ``batch``, learnt
    from the template model outside the transform (its running stats
    kept; no likelihood, so no kernel launch): every noise entry its
    forward reads, recorded as it is drawn (``NoiseRecorder``: a latent,
    a mixture's Gumbel and component noise, TotalVI's log β, SCANVI's z₂,
    AUTOZI's δ pair), every dropout mask, and the aux step's draws."""
    model = self.model
    noise = NoiseRecorder(model.device)
    masks = DropoutMasks()
    aux = None
    with torch.no_grad(), model._batch_stats_kept(True):
      model.module.train(True)
      x = model._masked_module_input(batch, True)
      library = batch.get("library") if model.uses_library else None
      try:
        model.module(x, library=library, generator=masks, noise=noise)
      except TypeError as e:  # a draw from the generator, not the recorder
        raise TypeError(f"{type(model).__name__}'s forward draws from its "
                        "generator where VmapEnsemble cannot feed the draw"
                        ) from e
      if model.aux is not None:
        aux = NoiseRecorder(model.device)
        model._aux_plan(batch, aux)
        aux = aux.entries
    return _Plan(noise.entries, masks.specs, aux)

  def _mine(self, t):
    """This rank's members of a whole fleet's draw (a tensor or a pair)."""
    lo, hi = self._rows
    if (lo, hi) == (0, self.n_models):
      return t
    if isinstance(t, tuple):
      return tuple(x[lo:hi] for x in t)
    return t[lo:hi]

  def _draws(self, plan: _Plan):
    """One fleet step's noise and dropout masks, (M, …) each (this rank's
    members of them)."""
    gen, m = self.generator, self.n_models
    noise = self._made(plan.noise)
    masks = [self._mine(torch.rand((m, *s), generator=gen,
                                   device=self.model.device)) < keep
             for s, keep in plan.masks]
    return noise, masks

  def _aux_draws(self, plan: _Plan):
    """One fleet step's aux-step draws, (M, …) each."""
    return self._made(plan.aux)

  def _made(self, entries):
    params = self._stacked["params"]
    if self._rows != (0, self.n_models):
      params = _FleetParams(params)
    return [None if e is None else
            self._mine(e(self.n_models, self.generator, params))
            for e in entries]

  def _make_step(self, shared: bool, has_library: bool, plan: _Plan):
    """The vmapped gradient of one member's loss: (params, buffers,
    aux params, inputs, mask, library, noise, masks, beta) → (grads,
    (loss, metrics)), every output with the member axis first."""
    loss_module = _MemberLoss(self.model)

    def member_loss(params, buffers, aux, inputs, mask, library, noise,
                    masks, beta):
      state = self._state(params, buffers, aux)
      loss, metrics, _ = torch.func.functional_call(
          loss_module, state, (self._batch(inputs, mask, library), beta,
                               noise, masks))
      return loss, metrics

    x_dim = None if shared else 0
    aux_dim = None if plan.aux is None else 0
    beta_dim = None if isinstance(self._beta([0]), float) else 0
    return torch.func.vmap(
        torch.func.grad_and_value(member_loss, has_aux=True),
        in_dims=(0, 0, aux_dim, x_dim, x_dim, x_dim if has_library else None,
                 self._dims(plan.noise), 0, beta_dim))

  def _make_aux_step(self, shared: bool, has_library: bool, plan: _Plan):
    """The vmapped gradient of one member's aux loss in its aux
    parameters: (aux params, params, buffers, inputs, mask, library,
    draws) → (grads, loss); None without an aux step."""
    if plan.aux is None:
      return None
    group = self.model._make_aux_optimizer().param_groups[0]
    self._aux_adam = (float(group["lr"]), group["betas"], group["eps"])
    aux_module = _MemberAuxLoss(self.model)

    def member_aux(aux, params, buffers, inputs, mask, library, draws):
      return torch.func.functional_call(
          aux_module, self._state(params, buffers, aux),
          (self._batch(inputs, mask, library), draws))

    x_dim = None if shared else 0
    return torch.func.vmap(
        torch.func.grad_and_value(member_aux),
        in_dims=(0, 0, 0, x_dim, x_dim, x_dim if has_library else None,
                 self._dims(plan.aux)))

  @staticmethod
  def _dims(entries):
    return [None if e is None else 0 for e in entries]

  @staticmethod
  def _member_draws(entries, i: int):
    """Member ``i``'s share of one fleet step's draws (``_draws``,
    ``_aux_draws``): a tensor's row, a pair's rows (a mixture's Gumbel
    and component noise, AUTOZI's δ), or None."""
    return [None if e is None else tuple(t[i] for t in e)
            if isinstance(e, tuple) else e[i] for e in entries]

  @staticmethod
  def _state(params, buffers, aux):
    state = {f"module.{k}": v for k, v in params.items()}
    state.update({f"module.{k}": v for k, v in buffers.items()})
    if aux is not None:
      state.update({f"aux.{k}": v for k, v in aux.items()})
    return state

  @staticmethod
  def _batch(inputs, mask, library):
    batch = {"inputs": list(inputs), "mask": mask}
    if library is not None:
      batch["library"] = library
    return batch

  def _train_step(self, step_fn, batch, noise, masks, lr, clipnorm: float,
                  aux=None):
    """One fleet step on the stacked state: every member's gradient in one
    vmapped call, then the stacked clipped Adam; with ``aux`` = (aux step
    function, aux draws), then ``_aux_train_step``. Returns the (M,)
    losses, the metrics and the pre-clip gradients, on the card."""
    st = self._stacked
    keys = list(st["params"])
    frozen = (None if "aux" not in st else
              {k: v.detach() for k, v in st["aux"]["params"].items()})
    grads, (loss, metrics) = step_fn(
        st["params"], st["buffers"], frozen, batch["inputs"], batch["mask"],
        batch.get("library"), noise, masks, self._beta(st["steps"]))
    clipped_adam_step_([st["params"][k] for k in keys],
                       [grads[k] for k in keys], [st["mu"][k] for k in keys],
                       [st["nu"][k] for k in keys], st["count"], lr, clipnorm)
    st["steps"] = [s + 1 for s in st["steps"]]
    if aux is not None:
      metrics = dict(metrics, disc_loss=self._aux_train_step(*aux, batch))
    return loss.detach(), metrics, grads

  def _aux_train_step(self, aux_fn, draws, batch) -> torch.Tensor:
    """The aux step of every member at its updated parameters and
    statistics: the vmapped gradient of its aux loss, then one unclipped
    Adam step with the aux optimizer's settings (FactorVAE's
    discriminator: ``optax.adam(discriminator_lr)``, its own count).
    Returns the (M,) aux losses before the step."""
    st, aux_st = self._stacked, self._stacked["aux"]
    grads, value = aux_fn(aux_st["params"], st["params"], st["buffers"],
                          batch["inputs"], batch["mask"],
                          batch.get("library"), draws)
    names = list(aux_st["params"])
    lr, (b1, b2), eps = self._aux_adam
    clipped_adam_step_([aux_st["params"][k] for k in names],
                       [grads[k] for k in names],
                       [aux_st["mu"][k] for k in names],
                       [aux_st["nu"][k] for k in names], aux_st["count"],
                       lr, 0.0, b1, b2, eps)
    return value.detach()

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
    between calls; each member's state is written back into its model.
    ``mesh``: the members split over the mesh's ranks (module
    docstring); every rank ends with the whole fleet."""
    lo, hi = self._member_split(mesh)
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
    sharded = (lo, hi) != (0, m_count)
    if sharded:  # this rank's members of the fleet's state and rates
      self._stacked, self._rows = _member_rows(self._stacked, lo, hi), (lo,
                                                                      hi)
      if isinstance(lr, torch.Tensor):
        lr = lr[lo:hi]
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

    plan = step_fn = aux_fn = None
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
          perm = self._mine(torch.argsort(torch.rand(
              (m_count, n), generator=gen, device=dev), dim=1))
          mask_all = self._mine((torch.rand((m_count, n), generator=gen,
                                            device=dev) < lp)
                                .to(torch.float32))
        loss_sum = torch.zeros((hi - lo,), device=dev)
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
            aux_fn = self._make_aux_step(shared_batches, library is not None,
                                         plan)
          loss = self._train_step(
              step_fn, batch, *self._draws(plan), lr, float(clipnorm or 0.0),
              None if aux_fn is None else (aux_fn, self._aux_draws(plan)))[0]
          loss_sum += loss
        win.append(loss_sum / steps)
      win_losses = torch.stack(win, 1)
      if sharded:
        win_losses = PF.all_gather_cat(win_losses, None, 0)
      win_losses = win_losses.cpu().numpy()  # (M, E): one fetch
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
    if sharded:  # every rank's members: the whole fleet on every rank
      self._stacked, self._rows = _gathered_members(self._stacked), (
          0, m_count)
    self._write_back(lrs, float(clipnorm or 0.0))
    return self

  def extract(self, index: int):
    """Member ``index`` as a standalone trained model."""
    return self.models[index]

  def best(self):
    if "loss" not in self.history:
      raise RuntimeError("fit the ensemble first")
    return self.extract(int(np.argmin(self.history["loss"][-1])))
