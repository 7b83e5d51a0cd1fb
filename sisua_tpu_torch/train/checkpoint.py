"""Checkpoints the JAX package reads and writes (port of
``sisua_tpu/train/checkpoint.py``).

The files are the JAX package's: ``params.msgpack``,
``batch_stats.msgpack`` and ``aux_params.msgpack`` (a second parameter
group: FactorVAE's discriminator) hold the flax pytrees
(``convert.torch_to_jax`` layout) in flax's msgpack encoding
(``train/msgpack.py``), and
``metamodel.json`` the class name, dataset, metadata and constructor
kwargs (``format_version`` 1). A checkpoint written by either package
loads in the other. In a world of ranks (a mesh fit) the files are
written by rank 0, and every rank waits until they are (``on_main_rank``).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np

from ..convert import _flat
from ..nn import NetConf
from ..rv import RVmeta
from . import msgpack

__all__ = ["save_weights", "load_weights", "save_metamodel", "load_metamodel",
           "encode_spec", "decode_spec", "on_main_rank"]


def on_main_rank(write) -> None:
  """``write()`` here without a world; in a world (every rank calls this)
  in rank 0, and the other ranks wait at a barrier until it has written."""
  from ..parallel.functional import barrier
  from ..parallel.mesh import is_main_rank
  if is_main_rank():
    write()
  barrier()


def encode_spec(obj):
  """JSON-encode RVmeta / NetConf / plain values, as the JAX package."""
  if isinstance(obj, RVmeta):
    return {"__rvmeta__": {"dim": obj.dim, "posterior": obj.posterior,
                           "projection": obj.projection, "name": obj.name,
                           "kwargs": list(map(list, obj.kwargs))}}
  if isinstance(obj, NetConf):
    d = dataclasses.asdict(obj)
    d["units"] = list(d["units"])
    return {"__netconf__": d}
  if isinstance(obj, (tuple, list)):
    return [encode_spec(o) for o in obj]
  if isinstance(obj, dict):
    return {k: encode_spec(v) for k, v in obj.items()}
  if isinstance(obj, (np.floating, np.integer)):
    return obj.item()
  return obj


def decode_spec(obj):
  if isinstance(obj, dict):
    if "__rvmeta__" in obj:
      d = obj["__rvmeta__"]
      return RVmeta(d["dim"], d["posterior"], d["projection"], d["name"],
                    tuple(tuple(kv) for kv in d.get("kwargs", [])))
    if "__netconf__" in obj:
      d = dict(obj["__netconf__"])
      d["units"] = tuple(d["units"])
      return NetConf(**d)
    return {k: decode_spec(v) for k, v in obj.items()}
  if isinstance(obj, list):
    return [decode_spec(o) for o in obj]
  return obj


def _refuse(backend: str = "msgpack") -> None:
  if backend == "orbax":
    raise NotImplementedError("backend='orbax' is not ported (msgpack only)")
  if backend != "msgpack":
    raise ValueError(f"unknown checkpoint backend {backend!r}")


def save_weights(path: str, params: Mapping, batch_stats: Optional[Mapping]
                 = None, aux_params: Optional[Mapping] = None,
                 backend: str = "msgpack") -> str:
  """Write <path>/params.msgpack (+ batch_stats.msgpack, +
  aux_params.msgpack): nested dicts of numpy arrays in the flax layout."""
  _refuse(backend)
  os.makedirs(path, exist_ok=True)
  for name, tree in (("params", params), ("batch_stats", batch_stats),
                     ("aux_params", aux_params)):
    if tree is not None:
      with open(os.path.join(path, f"{name}.msgpack"), "wb") as f:
        msgpack.dump(dict(tree), f)
  return path


def _check_leaves(name: str, template: Mapping, loaded: Mapping) -> None:
  """Every leaf's path and shape as the template's; names the first (in
  path order) that differs."""
  want = {p: tuple(np.shape(v)) for p, v in _flat(template)}
  got = {p: tuple(np.shape(v)) for p, v in _flat(loaded)}
  for p in sorted(set(want) | set(got)):
    if want.get(p) != got.get(p):
      where = f"{name}/{'/'.join(p)}"
      if p not in got:
        raise KeyError(f"checkpoint lacks leaf {where} {want[p]}")
      if p not in want:
        raise KeyError(f"checkpoint leaf {where} {got[p]} has no place in "
                       "the model")
      raise ValueError(f"checkpoint leaf {where} has shape {got[p]}, the "
                       f"model {want[p]}")


def load_weights(path: str, params_template: Mapping,
                 batch_stats_template: Optional[Mapping] = None,
                 aux_params_template: Optional[Mapping] = None
                 ) -> Tuple[Dict[str, Any], Optional[Dict[str, Any]],
                            Optional[Dict[str, Any]]]:
  """(params, batch_stats, aux_params) read from <path>, each checked leaf
  by leaf against its template; the batch-stats and aux templates come
  back when their file is absent, as in the JAX package."""
  if (not os.path.isfile(os.path.join(path, "params.msgpack"))
      and os.path.isdir(os.path.join(path, "orbax"))):
    _refuse("orbax")
  out = []
  for name, template in (("params", params_template),
                         ("batch_stats", batch_stats_template),
                         ("aux_params", aux_params_template)):
    file = os.path.join(path, f"{name}.msgpack")
    if template is None or (name != "params" and not os.path.isfile(file)):
      out.append(template)
      continue
    with open(file, "rb") as f:
      tree = msgpack.unpackb(f.read())
    _check_leaves(name, template, tree)
    out.append(tree)
  return tuple(out)


def save_metamodel(path: str, class_name: str, dataset: Optional[str],
                   metadata: Dict, init_kwargs: Dict) -> str:
  os.makedirs(path, exist_ok=True)
  manifest = {
      "class_name": class_name,
      "dataset": dataset,
      "metadata": encode_spec(metadata),
      "init_kwargs": encode_spec(init_kwargs),
      "format_version": 1,
  }
  with open(os.path.join(path, "metamodel.json"), "w") as f:
    json.dump(manifest, f, indent=2)
  return path


def load_metamodel(path: str):
  with open(os.path.join(path, "metamodel.json")) as f:
    m = json.load(f)
  return (m["class_name"], m.get("dataset"), decode_spec(m.get("metadata")),
          decode_spec(m.get("init_kwargs")))
