"""DataFeeder: host-side shuffled batches from CSR, dense or tensor sources
(the port's copy of ``sisua_tpu/data/feeder.py``).

The counts stay on the host; each batch gathers its shuffled rows into a
fresh dense float32 buffer with the native gather (``native/``). The
feeder yields numpy arrays; moving them to the card is the trainer's
work. Its random streams are the JAX feeder's numpy ones, so both yield
the same rows, masks and library rows, batch for batch:
  * epoch ``e`` shuffles with ``RandomState(seed + e)``;
  * the semi-supervised mask is Bernoulli(``labels_percent``), drawn ONCE
    per feeder (the reference caches its masking map, so the labeled
    subset is fixed for the run);
  * ``drop_remainder=True`` by default: every batch has ``batch_size``
    rows.
Batches are ``{'inputs': [x_0, …], 'mask': (B,), 'library': (B, 2)}``.

The port's fits also take torch tensors: a tensor source is gathered where
it lies and fetched (``_TensorSource``); the device-resident loop uses the
tensor itself.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch
from scipy import sparse

from ..native import csr_gather, dense_gather
from .utils import int16_exact

__all__ = ["DataFeeder"]


class _CSRSource:
  def __init__(self, m: sparse.spmatrix):
    m = m.tocsr()
    self.data = np.ascontiguousarray(m.data, np.float32)
    self.indices = np.ascontiguousarray(m.indices, np.int64)
    self.indptr = np.ascontiguousarray(m.indptr, np.int64)
    self.shape = m.shape

  def values(self):
    return self.data

  def gather(self, rows: np.ndarray, out: np.ndarray) -> np.ndarray:
    return csr_gather(self.data, self.indices, self.indptr, rows,
                      self.shape[1], out=out)


class _DenseSource:
  def __init__(self, m: np.ndarray):
    self.m = np.ascontiguousarray(m, np.float32)
    self.shape = m.shape

  def values(self):
    return self.m

  def gather(self, rows: np.ndarray, out: np.ndarray) -> np.ndarray:
    return dense_gather(self.m, rows, out=out)


class _TensorSource:
  """A torch tensor on any device: rows are gathered where it lies."""

  def __init__(self, t: torch.Tensor):
    self.t = t
    self.shape = tuple(t.shape)

  def values(self):
    return self.t

  def gather(self, rows: np.ndarray, out: np.ndarray) -> np.ndarray:
    idx = torch.as_tensor(np.asarray(rows, np.int64), device=self.t.device)
    out[:] = self.t.index_select(0, idx).to(torch.float32).cpu().numpy()
    return out


def _source(m):
  if isinstance(m, torch.Tensor):
    return _TensorSource(m)
  if sparse.issparse(m):
    return _CSRSource(m)
  return _DenseSource(np.asarray(m))


class DataFeeder:
  """Iterable over epoch batches with deterministic seeded shuffling."""

  def __init__(self,
               matrices: Sequence,
               library: Optional[np.ndarray] = None,
               labels_percent: float = 0.0,
               batch_size: int = 64,
               drop_remainder: bool = True,
               shuffle: int = 1000,
               seed: int = 1):
    if len(matrices) < 1:
      raise ValueError("DataFeeder needs at least one matrix")
    self.sources = [_source(m) for m in matrices]
    n = self.sources[0].shape[0]
    if any(s.shape[0] != n for s in self.sources):
      raise ValueError("all omics must share the cell axis")
    self.n_obs = n
    self.library = (np.ascontiguousarray(library, np.float32)
                    if library is not None else None)
    self.labels_percent = float(labels_percent)
    self.batch_size = int(batch_size)
    self.drop_remainder = bool(drop_remainder)
    self.shuffle = bool(shuffle)
    self.seed = int(seed)
    self._epoch = 0
    self._mask_all: Optional[np.ndarray] = None
    self.transfer_dtype = None  # see set_transfer_dtype

  def set_transfer_dtype(self, dtype) -> "DataFeeder":
    """Compress the host→device batch uploads: ``'int16'`` ships the
    gathered count matrices as int16 (exact for integral counts < 32767,
    checked here over every value), halving the bytes; ``'auto'`` does so
    when the data qualifies; ``None`` disables. The trainer widens each
    batch back to float32 on the device."""
    if dtype in (None, "float32"):
      self.transfer_dtype = None
      return self
    if dtype not in ("auto", "int16"):
      raise ValueError(f"transfer_dtype must be None|'float32'|'auto'|"
                       f"'int16', got {dtype!r}")
    if not all(int16_exact(src.values()) for src in self.sources):
      if dtype == "int16":
        raise ValueError("transfer_dtype='int16' requires integral counts "
                         "< 32768 in every source")
      self.transfer_dtype = None
    else:
      self.transfer_dtype = np.int16
    return self

  def _cast(self, xs):
    if self.transfer_dtype is None:
      return xs
    return [x.astype(self.transfer_dtype) for x in xs]

  # ------------------------------------------------------------------ sizing
  @property
  def n_inputs(self) -> int:
    return len(self.sources)

  @property
  def input_dims(self) -> List[int]:
    return [s.shape[1] for s in self.sources]

  def __len__(self) -> int:
    if self.drop_remainder:
      return self.n_obs // self.batch_size
    return int(np.ceil(self.n_obs / self.batch_size))

  # --------------------------------------------------------------- iteration
  def set_epoch(self, epoch: int) -> "DataFeeder":
    self._epoch = int(epoch)
    return self

  def _run_mask(self) -> np.ndarray:
    """Per-example semi-supervised mask, drawn once per feeder (a fixed
    labeled subset for the whole run, as the reference caches it)."""
    if self._mask_all is None:
      rng = np.random.RandomState((self.seed * 2654435761 + 0x5EED)
                                  % (2**31 - 1))
      self._mask_all = (rng.uniform(size=self.n_obs) <
                        self.labels_percent).astype(np.float32)
    return self._mask_all

  def _order(self) -> np.ndarray:
    rng = np.random.RandomState(self.seed + self._epoch)
    return (rng.permutation(self.n_obs) if self.shuffle
            else np.arange(self.n_obs)).astype(np.int64)

  def _gather(self, rows: np.ndarray) -> List[np.ndarray]:
    # a fresh buffer per batch: a batch in flight to the device must not
    # see its host buffer overwritten by the next gather
    return [src.gather(rows, out=np.empty((len(rows), src.shape[1]),
                                          np.float32))
            for src in self.sources]

  def __iter__(self) -> Iterator[Dict[str, object]]:
    order = self._order()
    mask_all = self._run_mask()
    for b in range(len(self)):
      rows = order[b * self.batch_size:(b + 1) * self.batch_size]
      batch: Dict[str, object] = {"inputs": self._cast(self._gather(rows)),
                                  "mask": mask_all[rows]}
      if self.library is not None:
        batch["library"] = self.library[rows]
      yield batch
    self._epoch += 1

  def iter_chunks(self, k: int) -> Iterator[Dict[str, object]]:
    """Epoch iterator over k-step chunks: arrays stacked to (k, B, D)."""
    order = self._order()
    mask_all = self._run_mask()
    bs = self.batch_size
    for c in range(self.n_chunks(k)):
      rows = order[c * k * bs:(c + 1) * k * bs]
      xs = [x.reshape(k, bs, x.shape[1]) for x in self._gather(rows)]
      batch: Dict[str, object] = {"inputs": self._cast(xs),
                                  "mask": mask_all[rows].reshape(k, bs)}
      if self.library is not None:
        batch["library"] = self.library[rows].reshape(k, bs, -1)
      yield batch
    self._epoch += 1

  def n_chunks(self, k: int) -> int:
    return self.n_obs // (k * self.batch_size)

  def full_batches(self, batch_size: Optional[int] = None
                   ) -> Iterator[Dict[str, object]]:
    """Sequential, un-shuffled, no-mask iteration (for predict/eval)."""
    bs = batch_size or self.batch_size
    for b in range(int(np.ceil(self.n_obs / bs))):
      rows = np.arange(b * bs, min((b + 1) * bs, self.n_obs), dtype=np.int64)
      batch = {"inputs": self._gather(rows),
               "mask": np.ones((len(rows),), np.float32)}
      if self.library is not None:
        batch["library"] = self.library[rows]
      yield batch
