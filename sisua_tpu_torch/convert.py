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

A module whose child's attribute name differs from its flax name (PEAKVI's
and MULTIVI's ``depth_head``, flax ``depth_logit``, whose name the method
``depth_logit`` holds) lists the pair in its ``flax_names``.

Any module whose submodules carry the flax names converts: the VAE
modules, and FactorVAE's discriminator (``dense{i}`` and ``logits``
Dense layers, ``aux_params`` in the JAX ``TrainState``), whose tree is
params only.

Both directions raise on any leaf left over on either side, so a topology
drift between the packages cannot pass silently. Inputs and outputs are
nested dicts of numpy arrays (``jax.device_get`` of a flax tree, or
``flax.core.unfreeze``); nothing here imports JAX.

Stacked trees (``jax_to_torch_stacked`` / ``torch_to_jax_stacked``): the
JAX ``VmapEnsemble`` stacks its members' ``TrainState``s on a leading
member axis, optax's Adam moments included; the port's ensemble keeps the
same stacked parameters, buffers and Adam state as dicts keyed like the
``state_dict`` (``train/ensemble.py``). Each member converts as above.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .nn import BatchNorm

__all__ = ["jax_to_torch", "torch_to_jax", "flax_param_path",
           "jax_to_torch_stacked", "torch_to_jax_stacked"]


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


def _renamed(module: nn.Module, parts: Tuple[str, ...], to_flax: bool
             ) -> Tuple[str, ...]:
  """``parts`` with its first name mapped through ``module.flax_names``
  (torch → flax, or back)."""
  names = getattr(module, "flax_names", {})
  if not to_flax:
    names = {v: k for k, v in names.items()}
  if len(parts) > 1 and parts[0] in names:
    return (names[parts[0]],) + tuple(parts[1:])
  return tuple(parts)


def _torch_key(module: nn.Module, path: Tuple[str, ...], collection: str
               ) -> Tuple[str, bool]:
  """(state_dict key, transpose?) for one flax leaf path."""
  path = _renamed(module, path, to_flax=False)
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
                 batch_stats: Optional[Mapping] = None,
                 params_only: bool = False) -> Dict[str, torch.Tensor]:
  """A ``state_dict`` for ``module`` from flax ``params`` (+
  ``batch_stats``); ``params_only``: the parameters' entries alone (a tree
  shaped like ``params``, e.g. Adam's moments). Raises on unmatched leaves
  or shapes, either side."""
  target = module.state_dict()
  if params_only:
    target = dict(module.named_parameters())
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
  return _renamed(module, tuple(owner) + (leaf,), to_flax=True)


def torch_to_jax(module: nn.Module,
                 values: Tuple[str, ...] = ("params", "batch_stats"),
                 state: Optional[Mapping[str, torch.Tensor]] = None
                 ) -> Tuple[Dict, Dict]:
  """(params, batch_stats) nested dicts of numpy arrays in the flax
  layout, the inverse of ``jax_to_torch``, of ``module``'s state or of
  ``state`` (entries keyed like it; parameters alone give an empty
  batch_stats). A kernel is transposed where the module lives, before its
  one copy to the host. A collection left out of ``values`` gets each
  leaf as a zero-stride array of its shape and dtype (a template that
  copies nothing)."""
  params: Dict = {}
  batch_stats: Dict = {}
  buffers = {k for k, _ in module.named_buffers()}
  for key, value in (module.state_dict() if state is None
                     else state).items():
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
    for p in _renamed(module, tuple(owner) + (leaf,), to_flax=True)[:-1]:
      node = node.setdefault(p, {})
    if collection in values:
      node[leaf] = value.contiguous().cpu().numpy()
    else:
      node[leaf] = np.broadcast_to(
          np.zeros((), torch.empty((), dtype=value.dtype).numpy().dtype),
          tuple(value.shape))
  return params, batch_stats


def _member(tree: Mapping, i: int) -> Dict:
  """Member ``i`` of a stacked nested dict."""
  return {k: _member(v, i) if isinstance(v, Mapping) else np.asarray(v)[i]
          for k, v in tree.items()}


def _stacked(trees) -> Dict:
  """Nested dicts of the same structure, stacked leaf by leaf."""
  return {k: _stacked([t[k] for t in trees]) if isinstance(v, Mapping)
          else np.stack([t[k] for t in trees])
          for k, v in trees[0].items()}


def jax_to_torch_stacked(module: nn.Module, params: Mapping,
                         batch_stats: Optional[Mapping] = None,
                         mu: Optional[Mapping] = None,
                         nu: Optional[Mapping] = None
                         ) -> Dict[str, Dict[str, torch.Tensor]]:
  """A JAX stacked tree (every leaf with a leading member axis: flax
  ``params``, ``batch_stats``, and Adam's ``mu`` / ``nu`` shaped like
  ``params``) → {'params', 'buffers', 'mu', 'nu'} of the port's ensemble,
  each a dict of (M, …) tensors on ``module``'s device keyed like its
  ``state_dict``. Moments left out are zeros (a fresh Adam state)."""
  first = params
  while isinstance(first, Mapping):
    first = next(iter(first.values()))
  n = int(np.shape(first)[0])
  names = [k for k, _ in module.named_parameters()]

  def stack(states):
    return {k: torch.stack([s[k] for s in states]) for k in states[0]}
  full = stack([jax_to_torch(module, _member(params, i),
                             None if batch_stats is None
                             else _member(batch_stats, i))
                for i in range(n)])
  out = {"params": {k: full[k] for k in names},
         "buffers": {k: v for k, v in full.items() if k not in names}}
  for name, tree in (("mu", mu), ("nu", nu)):
    out[name] = ({k: torch.zeros_like(v) for k, v in out["params"].items()}
                 if tree is None else
                 stack([jax_to_torch(module, _member(tree, i),
                                     params_only=True) for i in range(n)]))
  return out


def torch_to_jax_stacked(module: nn.Module,
                         stacked: Mapping[str, Mapping[str, torch.Tensor]]
                         ) -> Dict[str, Dict]:
  """The inverse of ``jax_to_torch_stacked``: {'params', 'batch_stats',
  'mu', 'nu'} nested dicts of numpy arrays in the flax layout, every leaf
  with the member axis first."""
  n = int(next(iter(stacked["params"].values())).shape[0])

  def member(d, i):
    return {k: v[i] for k, v in d.items()}
  out: Dict[str, Dict] = {}
  per = [torch_to_jax(module, state={**member(stacked["params"], i),
                                     **member(stacked["buffers"], i)})
         for i in range(n)]
  out["params"] = _stacked([p for p, _ in per])
  out["batch_stats"] = _stacked([b for _, b in per]) if per[0][1] else {}
  for name in ("mu", "nu"):
    out[name] = _stacked([torch_to_jax(module,
                                       state=member(stacked[name], i))[0]
                          for i in range(n)])
  return out
