"""JAX (flax) parameters ⇄ the port's ``state_dict``.

The JAX package keeps ``params`` and ``batch_stats`` as nested dicts keyed
by flax module names; the port's modules carry the same names, so a path
maps to a ``state_dict`` key by joining with '.'. Leaf renames:

  flax Dense ``kernel`` (in, out)   ↔  ``weight`` (out, in), transposed
  flax Conv ``kernel`` (k, in, out) ↔  ``weight`` (out, in, k): every
                                       kernel's axes are reversed
  flax Dense ``bias``               ↔  ``bias``
  flax BatchNorm ``scale``/``bias`` ↔  ``weight``/``bias``
  batch_stats ``mean``/``var``      ↔  ``running_mean``/``running_var``
  a bare ``self.param`` (e.g. ``px_r_single``) keeps its name.

Any module whose submodules carry the flax names converts: the VAE
modules, and FactorVAE's discriminator (``dense{i}`` and ``logits``
Dense layers, ``aux_params`` in the JAX ``TrainState``), whose tree is
params only.

Both directions raise on any leaf left over on either side, so a topology
drift between the packages cannot pass silently. Inputs and outputs are
nested dicts of numpy arrays (``jax.device_get`` of a flax tree, or
``flax.core.unfreeze``); nothing here imports JAX.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .nn import BatchNorm

__all__ = ["jax_to_torch", "torch_to_jax", "flax_param_path"]


def _flat(tree: Mapping, prefix: Tuple[str, ...] = ()):
  for k, v in tree.items():
    path = prefix + (str(k),)
    if isinstance(v, Mapping):
      yield from _flat(v, path)
    else:
      yield path, v


def _reversed_axes(t: torch.Tensor) -> torch.Tensor:
  """A kernel in the other package's layout: Dense (in, out) ↔ (out, in),
  Conv (k, in, out) ↔ (out, in, k)."""
  return t.permute(*range(t.ndim - 1, -1, -1))


def _owner_is_batchnorm(module: nn.Module, owner: str) -> bool:
  try:
    return isinstance(module.get_submodule(owner), BatchNorm)
  except AttributeError:
    return False


def _torch_key(module: nn.Module, path: Tuple[str, ...], collection: str
               ) -> Tuple[str, bool]:
  """(state_dict key, transpose?) for one flax leaf path."""
  owner, leaf = ".".join(path[:-1]), path[-1]
  if collection == "batch_stats":
    name = {"mean": "running_mean", "var": "running_var"}.get(leaf, leaf)
    transpose = False
  elif leaf == "kernel":
    name, transpose = "weight", True
  elif leaf == "scale" and _owner_is_batchnorm(module, owner):
    name, transpose = "weight", False
  else:
    name, transpose = leaf, False
  return (f"{owner}.{name}" if owner else name), transpose


def jax_to_torch(module: nn.Module, params: Mapping,
                 batch_stats: Optional[Mapping] = None
                 ) -> Dict[str, torch.Tensor]:
  """A ``state_dict`` for ``module`` from flax ``params`` (+
  ``batch_stats``). Raises on unmatched leaves or shapes, either side."""
  target = module.state_dict()
  out: Dict[str, torch.Tensor] = {}
  for collection, tree in (("params", params),
                           ("batch_stats", batch_stats or {})):
    for path, value in _flat(tree):
      key, transpose = _torch_key(module, path, collection)
      if key not in target:
        raise KeyError(f"JAX leaf {collection}/{'/'.join(path)} has no "
                       f"torch counterpart (looked for '{key}')")
      if key in out:
        raise KeyError(f"two JAX leaves map onto '{key}'")
      arr = np.asarray(value, np.float32)
      ref = target[key]
      shape = arr.shape[::-1] if transpose else arr.shape
      if tuple(shape) != tuple(ref.shape):
        raise ValueError(f"'{key}': JAX shape {shape} != torch shape "
                         f"{tuple(ref.shape)}")
      # one host copy at most; a kernel is transposed where it lands
      t = (torch.from_numpy(arr) if arr.flags.writeable
           else torch.tensor(arr)).to(device=ref.device, dtype=ref.dtype,
                                      copy=True)
      out[key] = _reversed_axes(t).contiguous() if transpose else t
  missing = sorted(set(target) - set(out))
  if missing:
    raise KeyError(f"torch state entries with no JAX leaf: {missing}")
  return out


def flax_param_path(module: nn.Module, key: str) -> Tuple[str, ...]:
  """The flax ``params`` path of one of ``module``'s parameters
  (``state_dict`` key → ('decoder0', 'dense0', 'kernel')): the names
  ``torch_to_jax`` writes it under. ``freeze`` prefixes match these."""
  parts = key.split(".")
  owner, leaf = parts[:-1], parts[-1]
  if leaf == "weight":
    leaf = ("scale" if _owner_is_batchnorm(module, ".".join(owner))
            else "kernel")
  return tuple(owner) + (leaf,)


def torch_to_jax(module: nn.Module,
                 values: Tuple[str, ...] = ("params", "batch_stats")
                 ) -> Tuple[Dict, Dict]:
  """(params, batch_stats) nested dicts of numpy arrays in the flax
  layout, the inverse of ``jax_to_torch``. A kernel is transposed where
  the module lives, before its one copy to the host. A collection left
  out of ``values`` gets each leaf as a zero-stride array of its shape
  and dtype (a template that copies nothing)."""
  params: Dict = {}
  batch_stats: Dict = {}
  buffers = {k for k, _ in module.named_buffers()}
  for key, value in module.state_dict().items():
    parts = key.split(".")
    owner, leaf = parts[:-1], parts[-1]
    value = value.detach()
    if key in buffers:
      names = {"running_mean": "mean", "running_var": "var"}
      if leaf not in names:
        raise KeyError(f"buffer '{key}' has no flax batch_stats leaf")
      collection, tree, leaf = "batch_stats", batch_stats, names[leaf]
    else:
      collection, tree = "params", params
      if leaf == "weight":
        if _owner_is_batchnorm(module, ".".join(owner)):
          leaf = "scale"
        else:
          leaf, value = "kernel", _reversed_axes(value)
    node = tree
    for p in owner:
      node = node.setdefault(p, {})
    if collection in values:
      node[leaf] = value.contiguous().cpu().numpy()
    else:
      node[leaf] = np.broadcast_to(
          np.zeros((), torch.empty((), dtype=value.dtype).numpy().dtype),
          tuple(value.shape))
  return params, batch_stats
