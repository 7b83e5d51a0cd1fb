"""``--mesh`` of the CLIs: a process that torchrun started joins its world;
otherwise the command starts one here with ``parallel.spawn`` and runs
itself in every rank (NCCL ranks on the cards, gloo ranks with
``--device cpu``). Rank 0 writes the files and the output."""

from __future__ import annotations

from typing import Callable, Sequence


def world_size(mesh: str, device: str) -> int:
  """The ranks ``--mesh`` asks for: 'all' is one per card, N is N."""
  import torch
  if str(mesh) != "all":
    return int(mesh)
  n = torch.cuda.device_count() if torch.device(device).type == "cuda" \
      else 0
  if n == 0:
    raise SystemExit("--mesh all is one rank per card and this machine "
                     f"gives --device {device} none: pass --mesh N")
  return n


def joined() -> bool:
  """Whether this process is a rank of a world (torchrun's, joined now,
  or one ``start`` made)."""
  from ..parallel import init_from_env
  return init_from_env()


def start(main: Callable, argv: Sequence[str], world: int, device: str):
  """``main(argv)`` in every rank of a new world of ``world`` ranks on
  this host; rank 0's result."""
  import torch
  from ..parallel import spawn
  backend = "gloo" if torch.device(device).type == "cpu" else None
  return spawn(main, world, backend=backend, args=(list(argv),))[0]
