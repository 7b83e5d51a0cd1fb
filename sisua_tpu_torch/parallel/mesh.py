"""The device mesh on ``torch.distributed`` (port of
``sisua_tpu/parallel/mesh.py``).

The JAX package lays its devices out as an (n_data × n_model) mesh and lets
GSPMD place the collectives: the cell axis of every batch is sharded over
'data', and every 2-D parameter leaf whose output axis is at least 1,024
and divides by ``n_model`` is column-sharded over 'model'. Here the mesh is
a ``torch.distributed.device_mesh.DeviceMesh`` of shape (n_data, n_model)
with the dimension names ('data', 'model') over one process per device:
rank ``d·n_model + m`` is data row d, model column m (JAX's reshape
order). The collectives are written out (``parallel/functional.py``).

A mesh needs a process group of exactly ``n_data·n_model`` ranks: start
the ranks with ``torchrun`` (``init_from_env`` joins them) or with
``spawn``, which starts them on this host with a file store in a
temporary directory. NCCL serves ranks that each own a card; gloo the
CPU, or ranks that share one card when the caller asks for it.

``shard_batch`` and ``shard_params`` return the calling rank's part as
plain tensors (no DTensor). ``param_plan`` is ``_param_spec``'s rule in
torch terms and needs no world.
"""

from __future__ import annotations

import os
import queue
import shutil
import tempfile
import time
import traceback
from datetime import timedelta
from typing import (Any, Callable, Dict, Mapping, NamedTuple, Optional,
                    Sequence, Tuple)

import torch
import torch.distributed as dist

__all__ = ["create_mesh", "batch_sharding", "replicated_sharding",
           "shard_batch", "shard_params", "device_memory_limit",
           "DATA_AXIS", "MODEL_AXIS", "param_plan", "spawn",
           "init_from_env", "default_backend", "axis_size", "axis_rank",
           "row_range", "is_main_rank"]

DATA_AXIS = "data"
MODEL_AXIS = "model"
#: the narrowest output axis the model axis splits (``_param_spec``)
MIN_SPLIT_WIDTH = 1024

_START_HELP = ("start the ranks with torchrun (then "
               "sisua_tpu_torch.parallel.init_from_env()), or run the work "
               "under sisua_tpu_torch.parallel.spawn(fn, world_size)")


def device_memory_limit(default: int = 16 * 1024 ** 3,
                        device=None) -> int:
  """A card's memory in bytes (``device``'s, else the current one's);
  ``default`` for a CPU device or without a card (the JAX package's CPU
  assumption). Shared by the trainer's residency budget and the serving
  chunker."""
  if device is None:
    if not torch.cuda.is_available():
      return int(default)
    return int(torch.cuda.mem_get_info()[1])
  device = torch.device(device)
  if device.type != "cuda":
    return int(default)
  return int(torch.cuda.mem_get_info(device)[1])


def default_backend(world_size: int) -> str:
  """NCCL when every rank can own a card, gloo without a card. Ranks
  that would share a card raise: they run only under an explicit
  ``backend='gloo'`` (NCCL refuses two ranks on one device)."""
  if not torch.cuda.is_available():
    return "gloo"
  n = torch.cuda.device_count()
  if world_size > n:
    raise RuntimeError(f"{world_size} ranks for {n} card(s): NCCL needs a "
                       "card per rank; pass backend='gloo' to share cards")
  return "nccl"


def create_mesh(n_data: Optional[int] = None, n_model: int = 1,
                devices: Optional[Sequence[int]] = None):
  """(n_data × n_model) ``DeviceMesh`` over the world's ranks (``devices``:
  the ranks, which must be the whole world); ``n_data`` defaults to all
  of them over ``n_model``. Raises without a process group."""
  if not (dist.is_available() and dist.is_initialized()):
    raise RuntimeError("create_mesh needs a torch.distributed process "
                       f"group: {_START_HELP}")
  world = dist.get_world_size()
  ranks = list(range(world)) if devices is None else [int(r)
                                                      for r in devices]
  n_dev = len(ranks)
  if n_data is None:
    n_data = n_dev // n_model
  assert n_data * n_model == n_dev, \
      f"{n_data}×{n_model} mesh cannot cover {n_dev} devices"
  if ranks != list(range(world)):
    raise ValueError(f"a mesh covers the whole world of {world} ranks in "
                     f"order, got {ranks}")
  from torch.distributed.device_mesh import init_device_mesh
  device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
  return init_device_mesh(device_type, (int(n_data), int(n_model)),
                          mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def axis_size(mesh, axis: str) -> int:
  return int(mesh.size(mesh.mesh_dim_names.index(axis)))


def axis_rank(mesh, axis: str) -> int:
  return int(mesh.get_local_rank(mesh.mesh_dim_names.index(axis)))


def is_main_rank() -> bool:
  """Whether this process writes files and output: rank 0, or no world."""
  return not (dist.is_available() and dist.is_initialized()) \
      or dist.get_rank() == 0


def row_range(n: int, parts: int, index: int) -> Tuple[int, int]:
  """Rows [lo, hi) of part ``index`` of ``n`` rows in ``parts``
  contiguous parts, the first ones a row longer when they do not divide."""
  base, extra = divmod(int(n), int(parts))
  lo = index * base + min(index, extra)
  return lo, lo + base + (1 if index < extra else 0)


class NamedSharding(NamedTuple):
  """A mesh and the axes a tensor's dimensions are split over (JAX's
  ``NamedSharding(mesh, PartitionSpec(...))``; empty: replicated)."""
  mesh: Any
  spec: Tuple


def batch_sharding(mesh) -> NamedSharding:
  """Shard the leading (cell) axis across the data axis."""
  return NamedSharding(mesh, (DATA_AXIS,))


def replicated_sharding(mesh) -> NamedSharding:
  return NamedSharding(mesh, ())


def _tree_map(fn, tree):
  if isinstance(tree, Mapping):
    return {k: _tree_map(fn, v) for k, v in tree.items()}
  if isinstance(tree, (list, tuple)):
    return type(tree)(_tree_map(fn, v) for v in tree)
  return fn(tree)


def shard_batch(batch, mesh):
  """The calling rank's rows of every leaf of a batch ({'inputs': [...],
  'library', 'mask'}, or any nested dict/list of tensors and arrays): its
  data row's contiguous part of the cell axis."""
  n_data, d = axis_size(mesh, DATA_AXIS), axis_rank(mesh, DATA_AXIS)

  def take(x):
    if x is None:
      return None
    lo, hi = row_range(x.shape[0], n_data, d)
    return x[lo:hi]
  return _tree_map(take, batch)


def _leaf_shape(v) -> Tuple[int, ...]:
  return tuple(v.shape) if hasattr(v, "shape") else tuple(v)


def param_plan(params: Mapping[str, Any], n_model: int) -> Dict[str, int]:
  """{state_dict key: torch dim} of the leaves the model axis splits:
  ``_param_spec``'s rule, a 2-D leaf whose JAX output axis is at least
  1,024 wide and divides by ``n_model``. A Dense ``weight`` is flax's
  kernel transposed, (out, in): its dim 0; a bare 2-D parameter keeps the
  JAX layout, (·, out): its dim 1. ``params`` maps keys to tensors or
  shapes (no world needed)."""
  plan: Dict[str, int] = {}
  if int(n_model) <= 1:
    return plan
  for key, v in params.items():
    shape = _leaf_shape(v)
    if len(shape) != 2:
      continue
    dim = 0 if key.rsplit(".", 1)[-1] == "weight" else 1
    if shape[dim] % int(n_model) == 0 and shape[dim] >= MIN_SPLIT_WIDTH:
      plan[key] = dim
  return plan


def shard_params(params: Mapping[str, torch.Tensor], mesh
                 ) -> Dict[str, torch.Tensor]:
  """The calling rank's part of a state dict: its model column's slice of
  every leaf ``param_plan`` splits, every other leaf whole."""
  n_model, m = axis_size(mesh, MODEL_AXIS), axis_rank(mesh, MODEL_AXIS)
  plan = param_plan(params, n_model)
  out = {}
  for k, v in params.items():
    if k in plan:
      size = v.shape[plan[k]] // n_model
      v = v.narrow(plan[k], m * size, size)
    out[k] = v
  return out


# --------------------------------------------------------------- the world
def init_from_env(backend: Optional[str] = None) -> bool:
  """Join the world ``torchrun`` describes (RANK, WORLD_SIZE,
  MASTER_ADDR, LOCAL_RANK); the NCCL rank takes its LOCAL_RANK's card
  first. False when the environment describes no world; True when a
  process group is up."""
  if dist.is_initialized():
    return True
  if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
    return False
  world = int(os.environ["WORLD_SIZE"])
  backend = backend or default_backend(int(os.environ.get(
      "LOCAL_WORLD_SIZE", world)))
  _take_card(int(os.environ.get("LOCAL_RANK", os.environ["RANK"])), backend)
  dist.init_process_group(backend)
  return True


def _take_card(local_rank: int, backend: str) -> None:
  """``torch.cuda.set_device`` before any model is built, so
  ``resolve_device('cuda')`` gives the rank's card; gloo ranks share the
  cards round-robin."""
  if torch.cuda.is_available():
    torch.cuda.set_device(local_rank % torch.cuda.device_count())


def _rank_main(fn, rank, world, backend, store_path, timeout, args, kwargs,
               results):
  os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                    WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world))
  try:
    _take_card(rank, backend)
    dist.init_process_group(backend, store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=timeout))
    out = fn(*args, **kwargs)
  except BaseException as e:  # noqa: BLE001 — re-raised in the caller
    tb = traceback.format_exc()
    try:
      import pickle
      pickle.dumps(e)
    except Exception:  # noqa: BLE001 — an exception pickle cannot carry
      e = RuntimeError(f"{type(e).__name__}: {e}")
    # delivered before this rank leaves the world, so that the failures
    # it causes in the other ranks arrive after it
    results.put((rank, False, e, tb))
    results.close()
    results.join_thread()
    if dist.is_initialized():
      dist.destroy_process_group()
    return
  dist.destroy_process_group()
  results.put((rank, True, out, None))


def spawn(fn: Callable, world_size: int, backend: Optional[str] = None,
          args: Sequence = (), kwargs: Optional[Dict] = None,
          timeout: float = 900.0) -> list:
  """Run ``fn(*args, **kwargs)`` in ``world_size`` new ranks of one world
  on this host (``torch.multiprocessing``'s spawn method, a file store in
  a temporary directory) and return each rank's result, by rank. The
  backend is ``default_backend``'s unless given: NCCL with a card per
  rank (each rank calls ``torch.cuda.set_device(rank)`` first), gloo on
  the CPU; ranks share a card only under ``backend='gloo'``. The first
  rank's exception is raised again here and the other ranks are stopped;
  past ``timeout`` seconds (a hung collective) every rank is stopped and
  ``TimeoutError`` raised. ``fn`` must be importable by name."""
  import torch.multiprocessing as mp
  world_size = int(world_size)
  backend = backend or default_backend(world_size)
  ctx = mp.get_context("spawn")
  results = ctx.Queue()
  tmp = tempfile.mkdtemp(prefix="sisua_world_")
  store = os.path.join(tmp, "store")
  procs = [ctx.Process(target=_rank_main,
                       args=(fn, r, world_size, backend, store, timeout,
                             tuple(args), dict(kwargs or {}), results))
           for r in range(world_size)]
  for p in procs:
    p.start()
  out: Dict[int, Any] = {}
  deadline = time.monotonic() + float(timeout)
  try:
    while len(out) < world_size:
      try:
        rank, ok, value, tb = results.get(timeout=0.5)
      except queue.Empty:
        dead = [r for r, p in enumerate(procs)
                if p.exitcode not in (None, 0) and r not in out]
        if dead:
          raise RuntimeError(f"rank {dead[0]} died with exit code "
                             f"{procs[dead[0]].exitcode}")
        if time.monotonic() > deadline:
          raise TimeoutError(f"the {world_size} ranks did not finish in "
                             f"{timeout:.0f} s (a hung collective?)")
        continue
      if not ok:
        value.add_note(f"raised in rank {rank} of {world_size}:\n{tb}")
        raise value
      out[rank] = value
    for p in procs:
      p.join()
    return [out[r] for r in range(world_size)]
  finally:
    for p in procs:
      if p.is_alive():
        p.terminate()
    for p in procs:
      p.join(5)
      if p.is_alive():
        p.kill()
        p.join()
    results.close()
    shutil.rmtree(tmp, ignore_errors=True)
