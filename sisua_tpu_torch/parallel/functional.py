"""The collectives of a mesh step, and what the model code reads of it.

The JAX package keeps single-device semantics under GSPMD: a mesh step is
the single-device step on the same global batch, up to the order of sums.
The port keeps them with explicit collectives on the mesh's process
groups (no ``DistributedDataParallel``, FSDP or ``SyncBatchNorm``):

* ``active(mesh)`` marks a mesh fit or serving call; ``batch_rows(R, lo,
  hi)`` marks one global batch of R rows of which this rank holds
  [lo, hi). Outside them every helper below is the single-device code.
* Draws (``draw_rows``): every rank draws the *global* tensor from the
  same generator and keeps its rows, so the generators stay in step with
  the single-device run.
* Normalizers (``batch_mean``, ``batch_sum``, ``global_rows``): a mean
  over the batch is the local sum over the global count. Its value is
  the global mean on every rank (one all-reduce), its gradient the local
  share's, so the sum of the ranks' gradients is the global gradient
  whatever rows a rank holds (padded, masked, no labelled cell).
* BatchNorm's statistics (``batch_stats``): Σx, Σx² and the count summed
  over 'data' by a differentiable all-reduce.
* The gradients (``all_reduce_grads``): one flattened all-reduce over
  'data'.
* The model axis (``ModelSplit``): a split leaf is stored and optimized as
  the rank's slice; each step all-gathers the full leaf over 'model'
  (``_GatherSlices``), whose backward returns the rank's own slice of the
  gradient (every model rank of a data row computes the same loss on the
  same rows, so a sum would count it n_model times). The global norm of
  the clip counts split leaves' slices summed over 'model' and every
  other leaf once (``global_grad_norm``).

A collective over a group of one rank is skipped: with n_data = 1 the data
helpers are the single-device code, with n_model = 1 nothing is split.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .mesh import (DATA_AXIS, MODEL_AXIS, axis_rank, axis_size, param_plan,
                   row_range)

__all__ = ["MeshView", "active", "current", "batch_rows", "local_rows",
           "draw_rows", "batch_mean", "batch_means", "batch_sum",
           "batch_total", "replicated", "global_rows", "batch_stats",
           "gather_rows", "gather_batches", "data_sum", "all_reduce_grads",
           "global_grad_norm", "ModelSplit", "all_reduce", "all_gather_cat",
           "barrier"]


class MeshView:
  """What a step reads of a mesh: its sizes, this rank's coordinates and
  the 'data' and 'model' process groups."""

  def __init__(self, mesh):
    self.mesh = mesh
    self.n_data = axis_size(mesh, DATA_AXIS)
    self.n_model = axis_size(mesh, MODEL_AXIS)
    self.data_rank = axis_rank(mesh, DATA_AXIS)
    self.model_rank = axis_rank(mesh, MODEL_AXIS)
    names = mesh.mesh_dim_names
    self.data_group = mesh.get_group(names.index(DATA_AXIS))
    self.model_group = mesh.get_group(names.index(MODEL_AXIS))
    self.rank = dist.get_rank()

  def rows(self, n: int) -> Tuple[int, int]:
    """This rank's rows [lo, hi) of a global batch of ``n``."""
    return row_range(n, self.n_data, self.data_rank)


_VIEW: Optional[MeshView] = None
_ROWS: Optional[Tuple[int, int, int]] = None


def current() -> Optional[MeshView]:
  """The active mesh, or None."""
  return _VIEW


@contextlib.contextmanager
def active(mesh):
  """Run the block on ``mesh`` (None: on one device)."""
  global _VIEW
  prev = _VIEW
  _VIEW = None if mesh is None else (mesh if isinstance(mesh, MeshView)
                                     else MeshView(mesh))
  try:
    yield _VIEW
  finally:
    _VIEW = prev


@contextlib.contextmanager
def batch_rows(rows: int, lo: int, hi: int):
  """One global batch of ``rows`` rows, of which this rank holds [lo, hi)."""
  global _ROWS
  prev = _ROWS
  _ROWS = (int(rows), int(lo), int(hi))
  try:
    yield
  finally:
    _ROWS = prev


def _split_rows() -> Optional[Tuple[int, int, int]]:
  """(rows, lo, hi) when the cell axis is split over more than one rank."""
  if _VIEW is None or _ROWS is None or _VIEW.n_data == 1:
    return None
  return _ROWS


def local_rows(rows: int) -> Tuple[int, int]:
  """This rank's rows [lo, hi) of a global batch of ``rows`` on the
  active mesh, or all of them."""
  if _VIEW is None:
    return 0, int(rows)
  return _VIEW.rows(rows)


# ---------------------------------------------------------------- collectives
def all_reduce(t: torch.Tensor, group=None, op=dist.ReduceOp.SUM
               ) -> torch.Tensor:
  """In-place all-reduce (a no-op over one rank)."""
  if group is not None and dist.get_world_size(group) == 1:
    return t
  dist.all_reduce(t, op=op, group=group)
  return t


def barrier() -> None:
  if dist.is_available() and dist.is_initialized():
    dist.barrier()


def all_gather_cat(t: torch.Tensor, group, dim: int) -> torch.Tensor:
  """Every rank's ``t`` of ``group`` (None: the world) concatenated along
  ``dim`` in rank order (no gradient)."""
  n = dist.get_world_size(group)
  if n == 1:
    return t
  parts = [torch.empty_like(t) for _ in range(n)]
  dist.all_gather(parts, t.contiguous(), group=group)
  return torch.cat(parts, dim)


class _AllReduceSum(torch.autograd.Function):
  """Σ over a group; the backward sums the incoming gradients over it."""

  @staticmethod
  def forward(ctx, t, group):
    ctx.group = group
    return all_reduce(t.clone(), group)

  @staticmethod
  def backward(ctx, grad):
    return all_reduce(grad.contiguous().clone(), ctx.group), None


class _GatherSlices(torch.autograd.Function):
  """The full leaf from every model rank's slice along ``dim``; the
  backward is the rank's own slice of the gradient."""

  @staticmethod
  def forward(ctx, t, group, dim, index):
    ctx.dim, ctx.index, ctx.size = dim, index, t.shape[dim]
    return all_gather_cat(t.detach(), group, dim)

  @staticmethod
  def backward(ctx, grad):
    return (grad.narrow(ctx.dim, ctx.index * ctx.size, ctx.size)
            .contiguous(), None, None, None)


# ------------------------------------------------------------ the data axis
def draw_rows(draw: Callable[..., torch.Tensor], shape: Sequence[int],
              axis: int, *params: torch.Tensor) -> torch.Tensor:
  """``draw(shape, *params)``, a draw from a generator whose ``axis`` is
  the cell axis; ``params`` are the draw's per-cell parameters, with the
  cell axis at ``axis`` too. When the batch is split and ``shape[axis]``
  is this rank's rows, the parameters are gathered, the global tensor is
  drawn and this rank's rows kept (a draw without a cell axis, a
  per-gene one, is every rank's alike)."""
  shape = tuple(int(s) for s in shape)
  rows = _split_rows()
  if rows is None or not shape:
    return draw(shape, *params)
  n, lo, hi = rows
  axis = axis % len(shape)
  if shape[axis] != hi - lo:
    return draw(shape, *params)
  full = draw(shape[:axis] + (n,) + shape[axis + 1:],
              *(gather_rows(t, axis) for t in params))
  return full.narrow(axis, lo, hi - lo)


def global_rows(local: int) -> int:
  """The global batch's rows when this rank holds ``local`` of them."""
  rows = _split_rows()
  return int(local) if rows is None else rows[0]


def batch_sum(t: torch.Tensor) -> torch.Tensor:
  """Σ of ``t`` over the global batch (no gradient): a mask's count."""
  if _split_rows() is None:
    return t.sum()
  return data_sum(t.sum())


def _global_value(local: torch.Tensor) -> torch.Tensor:
  """The Σ of ``local`` over 'data' as its value, ``local``'s gradient."""
  total = all_reduce(local.detach().clone(), _VIEW.data_group)
  return local + (total - local.detach())


def batch_total(local: torch.Tensor) -> torch.Tensor:
  """A rank's share of a batch-level value (a local sum over a global
  count) → the global value, with the share's gradient."""
  return local if _split_rows() is None else _global_value(local)


def replicated(term: torch.Tensor) -> torch.Tensor:
  """A loss term every data rank computes whole (a per-gene prior term):
  its value as it is, its gradient over n_data, so the sum over 'data'
  counts it once."""
  if _split_rows() is None:
    return term
  share = term / _VIEW.n_data
  return share + (term - share).detach()


def batch_mean(v: torch.Tensor) -> torch.Tensor:
  """``v.mean()`` over the global batch: ``v`` is per cell (cells last,
  MC sample dims before), its count the global one (module docstring)."""
  rows = _split_rows()
  if rows is None:
    return v.mean()
  return _global_value(v.sum() / _global_count(v, rows[0]))


def _global_count(v: torch.Tensor, rows: int) -> int:
  """The global batch's element count of a per-cell ``v`` (cells last,
  MC sample dims before): a rank may hold no row."""
  return math.prod(v.shape[:-1]) * rows


def batch_means(vs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
  """``batch_mean`` of each of ``vs`` (per-cell vectors), in one
  all-reduce."""
  rows = _split_rows()
  if rows is None:
    return [v.mean() for v in vs]
  local = torch.stack([v.sum() / _global_count(v, rows[0]) for v in vs])
  total = _global_value(local)
  return list(total.unbind())


def batch_stats(x: torch.Tensor, axes: Tuple[int, ...]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
  """(E[x], E[x²]) over ``axes`` (all but the features), over the global
  batch: Σx, Σx² and the count summed over 'data' in one differentiable
  all-reduce."""
  rows = _split_rows()
  if rows is None:
    return x.mean(dim=axes), (x * x).mean(dim=axes)
  f = x.shape[-1]
  count = torch.full((1,), float(x.numel() // f), device=x.device,
                     dtype=x.dtype)
  local = torch.cat([x.sum(dim=axes), (x * x).sum(dim=axes), count])
  total = _AllReduceSum.apply(local, _VIEW.data_group)
  n = total[-1].detach()
  return total[:f] / n, total[f:2 * f] / n


def gather_batches(t: torch.Tensor, k: int, axis: int = 0) -> torch.Tensor:
  """Serving: ``t`` holds this rank's rows of k equal global batches one
  after the other along ``axis`` (k·b); every rank's, in cell order
  (k·B, B = n_data·b). Every data rank holds the same number of rows."""
  if _VIEW is None or _VIEW.n_data == 1:
    return t
  axis = axis % t.ndim
  parts = [torch.empty_like(t) for _ in range(_VIEW.n_data)]
  dist.all_gather(parts, t.contiguous(), group=_VIEW.data_group)
  lead, b = t.shape[:axis], t.shape[axis] // k
  parts = [p.reshape(lead + (k, b) + t.shape[axis + 1:]) for p in parts]
  out = torch.stack(parts, axis + 1)
  return out.reshape(lead + (k * b * _VIEW.n_data,) + t.shape[axis + 1:])


def gather_rows(t: torch.Tensor, axis: int = 0) -> torch.Tensor:
  """Every rank's rows of ``t`` along its cell ``axis``, in global order
  (no gradient): the global batch."""
  rows = _split_rows()
  if rows is None:
    return t
  n, lo, hi = rows
  t = t.detach()
  axis = axis % t.ndim
  # the parts may differ by a row: pad each to the longest, then trim
  size = -(-n // _VIEW.n_data)
  if hi - lo < size:
    pad = list(t.shape)
    pad[axis] = size - (hi - lo)
    t = torch.cat([t, t.new_zeros(pad)], axis)
  parts = [torch.empty_like(t) for _ in range(_VIEW.n_data)]
  dist.all_gather(parts, t.contiguous(), group=_VIEW.data_group)
  out = []
  for d, part in enumerate(parts):
    a, b = row_range(n, _VIEW.n_data, d)
    out.append(part.narrow(axis, 0, b - a))
  return torch.cat(out, axis)


def data_sum(t: torch.Tensor) -> torch.Tensor:
  """``t`` summed over 'data' on the active mesh (serving's partial
  sums), else ``t``."""
  if _VIEW is None or _VIEW.n_data == 1:
    return t
  return all_reduce(t.detach().clone(), _VIEW.data_group)


def all_reduce_grads(params: Sequence[torch.Tensor]) -> None:
  """Sum the gradients over 'data', in one flattened buffer."""
  if _VIEW is None or _VIEW.n_data == 1:
    return
  grads = [p.grad for p in params if p.grad is not None]
  if not grads:
    return
  flat = torch.cat([g.reshape(-1) for g in grads])
  all_reduce(flat, _VIEW.data_group)
  off = 0
  for g in grads:
    g.copy_(flat[off:off + g.numel()].view_as(g))
    off += g.numel()


def global_grad_norm(params: Sequence[torch.Tensor],
                     split: Optional[set] = None) -> torch.Tensor:
  """optax's ``global_norm`` over the full tree: each replicated leaf
  once, each split leaf's slices (``split``: their ids) summed over
  'model'."""
  grads = [(p.grad, id(p) in (split or ())) for p in params
           if p.grad is not None]
  if not grads:
    return torch.zeros(())
  if not split or _VIEW is None or _VIEW.n_model == 1:
    return torch.sqrt(torch.stack([torch.sum(g * g)
                                   for g, _ in grads]).sum())
  sq = [torch.sum(g * g) for g, _ in grads]
  rep = torch.stack([s for s, (_, cut) in zip(sq, grads) if not cut]
                    or [sq[0] * 0]).sum()
  cut = torch.stack([s for s, (_, c) in zip(sq, grads) if c]).sum()
  return torch.sqrt(rep + all_reduce(cut.clone(), _VIEW.model_group))


# ----------------------------------------------------------- the model axis
def _param_states(inner) -> List[Tuple[torch.Tensor, Dict]]:
  """(parameter, its state dict) of an optimizer: ``torch.optim``'s keyed
  by parameter, ``optim._OptaxLike``'s a list aligned with its params."""
  if isinstance(inner, torch.optim.Optimizer):
    return [(p, inner.state[p]) for g in inner.param_groups
            for p in g["params"] if p in inner.state]
  return list(zip(inner.params, inner.state))


class ModelSplit:
  """The model axis on one module for a fit: every leaf ``param_plan``
  splits holds this rank's slice (its ``data``, so the parameter object,
  its key and the optimizer's reference stay), and so do the optimizer's
  state tensors of its shape. ``gathered()`` puts the full leaves in the
  owners' attributes for a step (``_GatherSlices``); ``full_state()`` is
  the state dict with full leaves (checkpoints); ``close()`` gathers the
  parameters and the optimizer state back, so the model is whole."""

  def __init__(self, module: torch.nn.Module, view: MeshView,
               optimizer=None):
    self.module, self.view = module, view
    named = dict(module.named_parameters())
    self.plan = param_plan({k: p.shape for k, p in named.items()},
                           view.n_model)
    self.entries = []
    for key, dim in self.plan.items():
      owner_name, _, attr = key.rpartition(".")
      owner = module.get_submodule(owner_name) if owner_name else module
      self.entries.append((key, owner, attr, named[key], dim))
    self.ids = {id(p) for _, _, _, p, _ in self.entries}
    self.optimizer = optimizer
    if self.entries and getattr(optimizer, "name", "adam") == "adafactor":
      raise ValueError("optimizer='adafactor' factors a leaf's second "
                       "moment over its whole matrix; a model axis holds "
                       "slices: use n_model=1 with adafactor")
    self._resize(self._slice, lambda p: p.shape)

  def _optimizer_states(self):
    # read afresh: a rollback's ``load_state_dict`` replaces the dicts
    if self.optimizer is None:
      return []
    return _param_states(getattr(self.optimizer, "inner", self.optimizer))

  def _resize(self, fn, shape_of) -> None:
    """Every split parameter and its optimizer state tensors of the
    parameter's shape through ``fn(tensor, dim)``."""
    states = self._optimizer_states()
    with torch.no_grad():
      for _, _, _, p, dim in self.entries:
        old = shape_of(p)
        p.grad = None
        p.data = fn(p.data, dim)
        for q, st in states:
          if q is p:
            for k, v in st.items():
              if isinstance(v, torch.Tensor) and v.shape == old:
                st[k] = fn(v, dim)

  def _slice(self, t: torch.Tensor, dim: int) -> torch.Tensor:
    size = t.shape[dim] // self.view.n_model
    return t.narrow(dim, self.view.model_rank * size, size).clone()

  def _gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
    return all_gather_cat(t.detach(), self.view.model_group, dim)

  @contextlib.contextmanager
  def gathered(self):
    """The full leaves, differentiable into the slices, for a step."""
    for _, owner, attr, p, dim in self.entries:
      owner.__dict__[attr] = _GatherSlices.apply(
          p, self.view.model_group, dim, self.view.model_rank)
    try:
      yield
    finally:
      for _, owner, attr, _, _ in self.entries:
        owner.__dict__.pop(attr, None)

  def full_state(self) -> Dict[str, torch.Tensor]:
    state = dict(self.module.state_dict())
    for key, _, _, p, dim in self.entries:
      state[key] = self._gather(p, dim)
    return state

  def close(self) -> None:
    self._resize(self._gather, lambda p: p.shape)
    self.entries = []
