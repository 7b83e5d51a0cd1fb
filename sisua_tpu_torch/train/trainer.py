"""Trainer — the port's three training loops (port of
``sisua_tpu/train/trainer.py``: ``make_optimizer``, ``fit``'s dispatch, the
streaming loop, ``_fit_device_cached``, ``_fit_out_of_core`` and
``evaluate``).

``fit`` picks the loop by the JAX rule:
  * ``device_cache=False`` (the default): the **streaming** loop. Each
    step's batch comes from the ``DataFeeder`` (host gather, fixed mask,
    library rows), prepared by a worker thread two batches ahead
    (``_prefetch_iter``) and copied to the card on a side stream.
    Validation runs every ``valid_freq`` steps (their mean lands on the
    epoch), else once at the end of the epoch; metrics are summed on the
    device and fetched once per epoch; ``max_iter`` stops at the step.
    ``scan_steps`` = k > 1 (when an epoch holds at least k batches): k
    batches are gathered and uploaded as one (k, B, D) chunk
    (``DataFeeder.iter_chunks``) and their k steps run from it; an epoch's
    steps round down to a multiple of k, and validation and ``max_iter``
    are checked once per chunk, across its k steps (the JAX loop's
    ``lax.scan`` over a chunk).
  * ``device_cache=True`` and the dense data within ``_device_budget()``:
    the **device-resident** loop. The matrices live on the device for the
    run (``device_dtype`` 'int16', exact for integral counts below 32,767
    in magnitude, or 'bfloat16', lossy, stores them in 2 bytes and each
    batch is widened to float32 after its gather); one permutation per
    epoch, ``n // batch_size`` full batches; validation and the metric
    fetch once per window of ``metrics_interval`` epochs, one history entry
    per epoch; only a window's last epoch, and only when the whole window
    is finite, may set the best; ``patience`` counts epochs, a window that
    does not improve charging all of its own; ``max_iter`` at window
    boundaries.
  * ``device_cache=True`` and larger data: the **out-of-core** loop when
    ``_plan_out_of_core`` gives a plan. Rows are randomly partitioned into
    equal chunks; ``n_resident`` of them stay on the device, the rest are
    uploaded each epoch by a worker thread while the previous chunk trains
    (a double buffer of two chunks). A CSR source whose triplets are
    clearly smaller than its dense rows uploads them and densifies on the
    device (``ops/sparse.py``). Each chunk runs the resident loop's epoch
    body; validation once per epoch.
  * else streaming, with the JAX message.
In every loop the semi-supervised mask is fixed for the run; a
non-finite epoch loss stops the run and, with ``allow_rollback``,
restores the best state; the monitored value is ``val_loss``, else
``loss``, and must beat the best by ``min_delta``; callbacks
(``TrainingCallback``) run in the JAX order: ``set_model`` first,
``on_epoch_begin`` before an epoch (the resident loop: for every epoch of
a window before it runs, with one logs dict per window),
``on_epoch_end`` before the epoch's logs are recorded (so a metric a
callback adds lands in ``history``), ``on_train_end`` once;
``checkpoint_fn(model)`` runs at each new best.

On a mesh (``Trainer(mesh=)``; ``parallel/functional.py``) every loop runs
one global step per batch: every rank makes the same permutation, mask
and batch order, keeps its data row's part of each batch and runs the
step under ``batch_rows``. Each rank holds the whole resident data (the
batches' rows are anywhere in it), so the memory budget is each rank's,
the least of them over the world, the same on every rank; so are the
loss sums of the epoch (global means), and with them every decision:
the NaN stop, early stopping, ``max_iter``. The resident loop needs a
batch that divides over 'data' (the JAX assertion); validation streams
(never the device-cached path) and takes global means.

Host→device copies run on a side stream of the card, from pinned host
memory; the training stream waits for them through an event, and each
tensor is recorded on the training stream, so the caching allocator
does not hand its memory to the next upload while a kernel still reads
it. On the CPU they are plain conversions.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..data.feeder import _TensorSource
from ..data.utils import int16_exact
from ..ops.sparse import col_dtype_for, csr_row_triplets, densify, worthwhile
from ..parallel import functional as PF
from ..parallel.mesh import DATA_AXIS, axis_size, device_memory_limit
from .optim import OPTIMIZERS, make_inner_optimizer

__all__ = ["Trainer", "TrainingCallback", "ClippedOptimizer", "ClippedAdam",
           "clip_by_global_norm_"]

_DEVICE_DTYPES = {"float32": torch.float32, "int16": torch.int16,
                  "bfloat16": torch.bfloat16}
# device memory assumed when there is no card to ask (the JAX package's
# device_memory_limit default)
_DEFAULT_DEVICE_MEMORY = 16 * 1024 ** 3
_INT16_MESSAGE = ("device_dtype='int16' needs integer counts < 32768; use "
                  "'bfloat16' (lossy) or 'float32' for this dataset")


class TrainingCallback:
  """Keras-style callback protocol (the JAX package's, ``set_model``,
  ``on_epoch_begin``, ``on_epoch_end``, ``on_train_end``)."""

  def set_model(self, model):
    self.model = model

  def on_epoch_begin(self, epoch: int, logs: Dict):
    pass

  def on_epoch_end(self, epoch: int, logs: Dict):
    pass

  def on_train_end(self, logs: Dict):
    pass


def clip_by_global_norm_(params, max_norm: float,
                         split: Optional[set] = None) -> torch.Tensor:
  """optax ``clip_by_global_norm``, in place on ``p.grad``: gradients are
  left alone when the global norm is below ``max_norm`` and otherwise
  become g / norm · max_norm. Unlike ``torch.nn.utils.clip_grad_norm_`` no
  1e-6 is added to the norm. ``split``: the ids of parameters the model
  axis holds as slices (their squares are summed over 'model'). Returns
  the norm; never syncs the host."""
  grads = [p.grad for p in params if p.grad is not None]
  if not grads:
    return torch.zeros(())
  norm = PF.global_grad_norm(params, split)
  keep = norm < max_norm
  for g in grads:
    g.copy_(torch.where(keep, g, g / norm * max_norm))
  return norm


class ClippedOptimizer:
  """``optax.chain(clip_by_global_norm(clipnorm), <optimizer>(lr))`` over
  ``params`` (``optim.py``; no clip when ``clipnorm`` is 0). Under
  ``freeze`` the caller passes the trainable parameters only: optax's
  ``masked`` wraps the whole chain, so the clip's global norm counts them
  alone, and the state exists only for them."""

  def __init__(self, params, learning_rate: float, clipnorm: float,
               name: str = "adam"):
    self.name = name
    self.params = [p for p in params if p.requires_grad]
    self.clipnorm = float(clipnorm)
    self.inner = make_inner_optimizer(name, self.params, learning_rate)
    #: a mesh fit's split leaves (``clip_by_global_norm_``'s ``split``)
    self.split_ids: Optional[set] = None

  def step(self):
    if self.clipnorm > 0:
      clip_by_global_norm_(self.params, self.clipnorm, self.split_ids)
    self.inner.step()

  def state_dict(self):
    return self.inner.state_dict()

  def load_state_dict(self, state):
    self.inner.load_state_dict(state)

  def carry_state(self, other: "ClippedOptimizer") -> None:
    """Continue ``other``'s optimizer state (moments, step count) under
    this call's hyperparameters, as the JAX ``fit`` keeps ``opt_state``
    across calls while it builds the transform anew from the call's
    arguments. Needs the same optimizer over the same parameters."""
    state = other.state_dict()
    if isinstance(self.inner, torch.optim.Optimizer):
      state = dict(state, param_groups=self.inner.state_dict()[
          "param_groups"])
    self.load_state_dict(state)


class ClippedAdam(ClippedOptimizer):
  """``optax.chain(clip_by_global_norm(clipnorm), adam(lr))``."""

  def __init__(self, params, learning_rate: float, clipnorm: float):
    super().__init__(params, learning_rate, clipnorm, "adam")


def _prefetch_iter(iterator, depth: int = 2):
  """Run the host-side batch producer (gather, upload) in a background
  thread ``depth`` items ahead, overlapping it with the training step.
  The worker's exceptions are raised again here; when the consumer
  abandons the generator (a ``max_iter`` break, an exception) the worker
  stops instead of parking on a full queue with its buffers."""
  q: "queue.Queue" = queue.Queue(maxsize=depth)
  end = object()
  stop = threading.Event()

  def offer(item) -> bool:
    while not stop.is_set():
      try:
        q.put(item, timeout=0.1)
        return True
      except queue.Full:
        continue
    return False

  def worker():
    try:
      for item in iterator:
        if not offer(item):
          return
      offer(end)
    except BaseException as e:  # noqa: BLE001 — re-raised at the consumer
      offer(e)

  threading.Thread(target=worker, daemon=True).start()
  try:
    while True:
      item = q.get()
      if item is end:
        return
      if isinstance(item, BaseException):
        raise item
      yield item
  finally:
    stop.set()
    try:  # drop any buffered items promptly
      while True:
        q.get_nowait()
    except queue.Empty:
      pass


class _Transfer:
  """Host→device copies of one fit, on a side stream of the card.

  ``put(fn)`` runs ``fn`` (which calls ``upload``) on the copy stream and
  returns ``(result, event)``; ``take`` on the training thread makes the
  current stream wait for the event and records every tensor of the
  result on it. On the CPU the event is None and nothing waits."""

  def __init__(self, dev: torch.device):
    self.dev = dev
    self.stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None

  def put(self, fn):
    if self.stream is None:
      return fn(), None
    with torch.cuda.device(self.dev), torch.cuda.stream(self.stream):
      out = fn()
      event = torch.cuda.Event()
      event.record(self.stream)
    return out, event

  def pin(self, a) -> torch.Tensor:
    """A host array (numpy or a CPU tensor) as a CPU tensor, pinned when
    there is a card to copy it to asynchronously."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(a))
    if self.stream is None or t.is_pinned():
      return t
    return t.pin_memory()

  def mark(self):
    """An event after the work enqueued so far on the training thread's
    stream (None on the CPU)."""
    if self.stream is None:
      return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(self.dev))
    return event

  def upload(self, a, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A host array on the device, then cast."""
    t = self.pin(a).to(self.dev, non_blocking=True)
    return t if dtype is None else t.to(dtype)

  def take(self, item, tensors: Callable):
    out, event = item
    if event is not None:
      cur = torch.cuda.current_stream(self.dev)
      cur.wait_event(event)
      for t in tensors(out):
        if t is not None:
          t.record_stream(cur)
    return out


def _batch_tensors(batch) -> List[torch.Tensor]:
  return [*batch["inputs"], batch["mask"], batch.get("library")]


def _chunk_tensors(chunk) -> List[torch.Tensor]:
  return [*chunk[0], chunk[1]]


def _host_seed(generator: torch.Generator) -> int:
  """A numpy seed drawn from the model's generator (the JAX trainer draws
  its host seeds from its key)."""
  return int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                           device=generator.device))


def _accumulate(acc, metrics: Dict[str, torch.Tensor], keys: List[str]):
  vec = torch.stack([metrics[k].detach().float() for k in keys])
  return vec if acc is None else acc + vec


class _Best:
  """A fit's best state: the monitored value, the model's snapshot and the
  epochs since it last improved."""

  def __init__(self, model):
    self.loss, self.snap, self.wait = np.inf, model._snapshot(), 0

  def take(self, model, loss: float) -> None:
    # the old snapshot goes first: a whole copy of the parameters and the
    # optimizer state would otherwise be alive twice
    self.snap = None
    self.loss, self.snap, self.wait = loss, model._snapshot(), 0


class Trainer:
  """Drives a model's ``_train_step`` over a ``DataFeeder``."""

  def __init__(self,
               optimizer: str = "adam",
               learning_rate: float = 1e-3,
               clipnorm: float = 100.0,
               valid_freq: int = 500,
               patience: int = 20,
               min_delta: float = 1e-4,
               terminate_on_nan: bool = True,
               allow_rollback: bool = True,
               max_iter: Optional[int] = None,
               device_cache: bool = False,
               device_dtype: str = "float32",
               metrics_interval: int = 1,
               hbm_budget_bytes: Optional[int] = None,
               device: Optional[torch.device] = None,
               scan_steps: int = 1,
               mesh=None,
               verbose: bool = False):
    """``device``: the card whose memory sets ``_device_budget`` (None:
    no card). ``scan_steps``: steps per uploaded chunk of the streaming
    loop (the resident and out-of-core loops ignore it, as JAX's do).
    ``mesh``: a ``parallel.create_mesh`` (module docstring)."""
    if optimizer != "adam" and optimizer not in OPTIMIZERS:
      raise ValueError(f"unknown optimizer {optimizer!r}; one of "
                       f"{sorted(['adam', *OPTIMIZERS])}")
    if device_dtype not in _DEVICE_DTYPES:
      raise ValueError(f"device_dtype must be float32|bfloat16|int16, "
                       f"got {device_dtype!r}")
    self.optimizer_name = optimizer
    self.learning_rate = float(learning_rate)
    self.clipnorm = float(clipnorm or 0.0)
    self.valid_freq = int(valid_freq)
    self.patience = int(patience)
    self.min_delta = float(min_delta)
    self.terminate_on_nan = bool(terminate_on_nan)
    self.allow_rollback = bool(allow_rollback)
    self.max_iter = max_iter
    self.device_cache = bool(device_cache)
    self.device_dtype = device_dtype
    self.metrics_interval = max(1, int(metrics_interval))
    self.hbm_budget_bytes = hbm_budget_bytes
    self.device = None if device is None else torch.device(device)
    self.scan_steps = max(1, int(scan_steps))
    self.verbose = bool(verbose)
    self.mesh = mesh
    self.history: Dict[str, List[float]] = {}
    self._eval_cache = None
    #: the budget of a mesh fit: the least over the world's ranks
    self._budget: Optional[int] = None
    self._oc_plan: Optional[Dict] = None
    #: out-of-core: seconds each epoch waited for a streamed chunk
    self._oc_wait_s: List[float] = []

  def make_optimizer(self, params) -> ClippedOptimizer:
    return ClippedOptimizer(params, self.learning_rate, self.clipnorm,
                            self.optimizer_name)

  def resident(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The training matrices in ``device_dtype``: int16 only when every
    value is an integer below 32,767 in magnitude (else it raises, as the
    JAX trainer does); bf16 rounds."""
    dt = _DEVICE_DTYPES[self.device_dtype]
    if dt == torch.float32:
      return list(xs)
    if dt == torch.int16 and not all(int16_exact(x) for x in xs):
      raise ValueError(_INT16_MESSAGE)
    return [x.to(dt) for x in xs]

  # ------------------------------------------------------------------- fit
  def fit(self, model, train_feeder, valid_feeder=None, epochs: int = 100,
          callbacks: Sequence[TrainingCallback] = (),
          checkpoint_fn: Optional[Callable] = None) -> None:
    """Train ``model`` (its ``_train_step(batch) -> metrics``) on
    ``train_feeder``; ``valid_feeder`` is evaluated by ``evaluate``."""
    for cb in callbacks:
      cb.set_model(model)
    if train_feeder.n_obs < train_feeder.batch_size:
      # drop_remainder would yield no batch at all
      train_feeder.batch_size = int(train_feeder.n_obs)
    args = (model, train_feeder, valid_feeder, epochs, callbacks,
            checkpoint_fn)
    try:
      with PF.active(self.mesh):
        if self.mesh is not None:
          self._budget = self._least_budget(model.device)
        if self.device_cache:
          if self._fits_device(train_feeder):
            return self._fit_device_cached(*args)
          if self._plan_out_of_core(train_feeder) is not None:
            return self._fit_out_of_core(*args)
          print("[trainer] device_cache requested but even one data chunk "
                "exceeds the device-memory budget — streaming instead")
        return self._fit_streaming(*args)
    finally:
      self._eval_cache = None  # the cached validation upload
      self._budget = None

  def _n_data(self) -> int:
    return 1 if self.mesh is None else axis_size(self.mesh, DATA_AXIS)

  def _least_budget(self, device) -> int:
    """The device budget of the world's poorest rank, so every rank picks
    the same loop and the same out-of-core plan."""
    t = torch.tensor([self._device_budget()], dtype=torch.int64,
                     device=device)
    return int(PF.all_reduce(t, op=torch.distributed.ReduceOp.MIN)[0])

  def _check_mesh_batch(self, batch_size: int) -> None:
    n_data = self._n_data()
    assert n_data == 1 or batch_size % n_data == 0, (
        f"batch_size {batch_size} must divide evenly over the {n_data}-way "
        "data mesh axis")

  def _fit_streaming(self, model, train_feeder, valid_feeder, epochs,
                     callbacks, checkpoint_fn):
    """Per-step batches from the feeder (JAX ``Trainer.fit``'s own loop)."""
    transfer = _Transfer(model.device)
    chunk = self.scan_steps
    use_scan = chunk > 1 and train_feeder.n_chunks(chunk) >= 1
    B = int(train_feeder.batch_size)
    lo, hi = PF.local_rows(B)

    def mine(a):
      """This rank's rows of a host batch (a chunk's second axis)."""
      if (lo, hi) == (0, B):
        return a
      return a[:, lo:hi] if use_scan else a[lo:hi]

    def upload(batch):
      def put():
        out = {"inputs": [transfer.upload(mine(x), torch.float32)
                          for x in batch["inputs"]],
               "mask": transfer.upload(mine(batch["mask"]))}
        if "library" in batch:
          out["library"] = transfer.upload(mine(batch["library"]))
        return out
      return transfer.put(put)

    def steps_of(item):
      """The batches of one uploaded item: itself, or a chunk's k."""
      if not use_scan:
        return [item]
      return [{key: ([x[j] for x in v] if key == "inputs" else v[j])
               for key, v in item.items()} for j in range(chunk)]

    best = _Best(model)
    stop = False
    acc, keys = None, None
    for epoch in range(epochs):
      logs: Dict[str, float] = {}
      for cb in callbacks:
        cb.on_epoch_begin(epoch, logs)
      t0 = time.perf_counter()
      n_examples = n_steps = 0
      val_metrics: Dict[str, list] = {}
      train_feeder.set_epoch(epoch)
      batches = _prefetch_iter(map(upload, train_feeder.iter_chunks(chunk)
                                   if use_scan else iter(train_feeder)))
      try:
        for item in batches:
          prev = model.step
          for batch in steps_of(transfer.take(item, _batch_tensors)):
            with PF.batch_rows(B, lo, hi):
              metrics = model._train_step(batch)
            if keys is None:
              keys = sorted(metrics)
            acc = _accumulate(acc, metrics, keys)
            n_examples += B
            n_steps += 1
          # periodic validation, valid_freq in steps, once per chunk
          if (valid_feeder is not None and self.valid_freq > 0
              and prev // self.valid_freq != model.step // self.valid_freq):
            for k, v in self.evaluate(model, valid_feeder).items():
              val_metrics.setdefault(f"val_{k}", []).append(v)
          if self.max_iter and model.step >= self.max_iter:
            stop = True
            break
      finally:
        batches.close()
      if acc is not None and n_steps > 0:  # the epoch's one fetch
        logs.update({k: float(v) / n_steps
                     for k, v in zip(keys, acc.cpu().numpy())})
        acc = None
      dt = time.perf_counter() - t0
      logs.update({k: float(np.mean(v)) for k, v in val_metrics.items()})
      logs["epoch_time"] = dt
      logs["cells_per_sec"] = n_examples / max(dt, 1e-9)
      # end-of-epoch validation when no step-periodic one ran
      if valid_feeder is not None and "val_loss" not in logs:
        logs.update({f"val_{k}": v
                     for k, v in self.evaluate(model, valid_feeder).items()})
      if self._end_epoch(model, epoch, logs, callbacks, checkpoint_fn, best,
                         f"({dt:.2f}s)") or stop:
        break
    for cb in callbacks:
      cb.on_train_end(dict(self.history))

  def _end_epoch(self, model, epoch, logs, callbacks, checkpoint_fn,
                 best: _Best, timing: str) -> bool:
    """Callbacks, history, the NaN stop, the best state and patience for
    one epoch of the streaming or out-of-core loop; True to stop."""
    for cb in callbacks:
      cb.on_epoch_end(epoch, logs)
    for k, v in logs.items():
      self.history.setdefault(k, []).append(v)
    if self.verbose:
      msg = " ".join(f"{k}={logs[k]:.4f}" for k in ("loss", "val_loss")
                     if k in logs)
      print(f"[epoch {epoch:03d}] {msg} {timing}")
    if self.terminate_on_nan and not np.isfinite(logs.get("loss", 0.0)):
      if self.verbose:
        print(f"[trainer] NaN loss at epoch {epoch}; terminating")
      if self.allow_rollback:
        model._restore(best.snap)
      return True
    monitored = logs.get("val_loss", logs.get("loss", np.inf))
    if monitored < best.loss - self.min_delta:
      if checkpoint_fn is not None:
        checkpoint_fn(model)
      best.take(model, monitored)
      return False
    best.wait += 1
    if self.patience > 0 and best.wait >= self.patience:
      if self.verbose:
        print(f"[trainer] early stopping at epoch {epoch}")
      if self.allow_rollback:
        model._restore(best.snap)
      return True
    return False

  # ------------------------------------------------------- device-resident
  def _device_budget(self, budget_fraction: float = 0.5) -> int:
    """Device bytes for resident training data: half of the card's memory
    (params, activations and the rest need the other half), JAX's 16 GB
    assumption when there is no card; ``hbm_budget_bytes`` overrides."""
    if self._budget is not None:
      return self._budget
    if self.hbm_budget_bytes is not None:
      return int(self.hbm_budget_bytes)
    return int(budget_fraction * device_memory_limit(
        _DEFAULT_DEVICE_MEMORY, self.device or "cpu"))

  def _bytes_per_row(self, feeder) -> int:
    itemsize = 4 if self.device_dtype == "float32" else 2
    return sum(itemsize * src.shape[1] for src in feeder.sources)

  def _fits_device(self, feeder) -> bool:
    """Whether the densified dataset fits the device budget (compressed
    storage halves its bytes)."""
    return (self._bytes_per_row(feeder) * feeder.n_obs
            <= self._device_budget())

  def _densify_rows(self, src, rows: np.ndarray,
                    validate: bool = True) -> torch.Tensor:
    """Rows of a feeder source as a dense host tensor in ``device_dtype``
    (int16 exact for integral counts, bf16 rounded). ``validate=False``
    skips the int16 range scan, for callers that checked the whole source
    once (the out-of-core loop uploads the same chunks every epoch)."""
    dense = src.gather(np.ascontiguousarray(rows, np.int64),
                       out=np.empty((len(rows), src.shape[1]), np.float32))
    if self.device_dtype == "int16":
      if validate and not int16_exact(dense):
        raise ValueError(_INT16_MESSAGE)
      return torch.from_numpy(dense.astype(np.int16))
    t = torch.from_numpy(dense)
    return t.to(torch.bfloat16) if self.device_dtype == "bfloat16" else t

  def _resident_matrix(self, src, dev) -> torch.Tensor:
    """A whole source on the device in ``device_dtype``; a tensor source
    is cast where it lies (on the card, no round trip through the host)."""
    if isinstance(src, _TensorSource):
      return self.resident([src.t.to(device=dev, dtype=torch.float32)])[0]
    return self._densify_rows(src, np.arange(src.shape[0])).to(dev)

  def _epoch_steps(self, model, xs, library, mask_all, batch_size, acc,
                   keys):
    """One epoch over device-resident matrices ``xs`` (all rows): a fresh
    permutation, ``n // batch_size`` full batches, every matrix of a batch
    gathered with the same rows and widened to float32 (on a mesh, this
    rank's part of each batch's rows). Returns the metric sums and their
    keys."""
    n = int(xs[0].shape[0])
    perm = torch.randperm(n, generator=model.generator, device=xs[0].device)
    lo, hi = PF.local_rows(batch_size)
    for i in range(n // batch_size):
      rows = perm[i * batch_size + lo:i * batch_size + hi]
      batch = {"inputs": [x.index_select(0, rows).to(torch.float32)
                          for x in xs],
               "mask": mask_all.index_select(0, rows)}
      if library is not None:
        batch["library"] = library.index_select(0, rows)
      with PF.batch_rows(batch_size, lo, hi):
        metrics = model._train_step(batch)
      if keys is None:
        keys = sorted(metrics)
      acc = _accumulate(acc, metrics, keys)
    return acc, keys

  def _fit_device_cached(self, model, train_feeder, valid_feeder, epochs,
                         callbacks, checkpoint_fn):
    dev = model.device
    xs = [self._resident_matrix(src, dev) for src in train_feeder.sources]
    library = (torch.from_numpy(train_feeder.library).to(dev)
               if train_feeder.library is not None else None)
    n = train_feeder.n_obs
    B = train_feeder.batch_size
    self._check_mesh_batch(B)
    steps = n // B
    mask_all = (torch.rand((n,), generator=model.generator, device=dev)
                < train_feeder.labels_percent).to(torch.float32)
    best = _Best(model)
    if self.max_iter and model.step >= self.max_iter:
      epochs = 0  # warm-started past the step budget: train nothing
    interval = self.metrics_interval
    keys: Optional[List[str]] = None
    epoch, stop = -1, False
    while epoch + 1 < epochs and not stop:
      remaining = epochs - (epoch + 1)
      window = interval if remaining >= interval else 1
      base_logs: Dict[str, float] = {}
      for e in range(epoch + 1, epoch + 1 + window):
        for cb in callbacks:
          cb.on_epoch_begin(e, base_logs)
      t_window = time.perf_counter()
      sums = []
      for _ in range(window):
        acc, keys = self._epoch_steps(model, xs, library, mask_all, B, None,
                                      keys)
        sums.append(acc)
      per_epoch = torch.stack(sums).cpu().numpy()  # the window's one fetch
      dt = (time.perf_counter() - t_window) / window
      val = (self.evaluate(model, valid_feeder) if valid_feeder is not None
             else {})
      window_finite = bool(np.isfinite(per_epoch[:, keys.index("loss")])
                           .all())
      for w in range(window):
        epoch += 1
        logs = dict(base_logs)
        logs.update({k: float(v) / steps for k, v in zip(keys, per_epoch[w])})
        logs["epoch_time"] = dt
        logs["cells_per_sec"] = steps * B / max(dt, 1e-9)
        if w == window - 1:
          logs.update({f"val_{k}": v for k, v in val.items()})
        for cb in callbacks:
          cb.on_epoch_end(epoch, logs)
        for k, v in logs.items():
          self.history.setdefault(k, []).append(v)
        if self.verbose:
          msg = " ".join(f"{k}={logs[k]:.4f}" for k in ("loss", "val_loss")
                         if k in logs)
          print(f"[epoch {epoch:03d}] {msg} ({dt:.3f}s)")
        if self.terminate_on_nan and not np.isfinite(logs["loss"]):
          if self.allow_rollback:
            model._restore(best.snap)
          stop = True
          break
        # only the window's last epoch may set the best: the snapshot is the
        # post-window state
        if w != window - 1:
          continue
        monitored = logs.get("val_loss", logs["loss"])
        if window_finite and monitored < best.loss - self.min_delta:
          best.take(model, monitored)
          if checkpoint_fn is not None:
            checkpoint_fn(model)
        else:
          best.wait += window  # patience is in epochs, charged per window
          if self.patience > 0 and best.wait >= self.patience:
            if self.allow_rollback:
              model._restore(best.snap)
            stop = True
            break
      if self.max_iter and model.step >= self.max_iter:
        stop = True
    for cb in callbacks:
      cb.on_train_end(dict(self.history))

  # ---------------------------------------------------------- out-of-core
  def _plan_out_of_core(self, feeder) -> Optional[Dict[str, int]]:
    """Chunk plan for data larger than the device budget: rows partition
    into equal chunks of ~budget/8; as many as fit, less a rotating pair
    (the double buffer), stay resident, the rest stream every epoch.
    None when even a one-batch chunk exceeds the budget (→ streaming)."""
    B = int(feeder.batch_size)
    n = int(feeder.n_obs)
    bpr = self._bytes_per_row(feeder)
    budget = self._device_budget()
    chunk_rows = min(n, (budget // 8) // max(1, bpr))
    chunk_rows = (chunk_rows // B) * B
    if chunk_rows < B:
      return None
    n_chunks = -(-n // chunk_rows)
    max_chunks = max(0, int(budget // (chunk_rows * bpr)))
    n_resident = max(0, min(n_chunks, max_chunks - 2))
    return {"chunk_rows": int(chunk_rows), "n_chunks": int(n_chunks),
            "n_resident": int(n_resident)}

  def _sparse_chunk_plans(self, feeder, chunk_rows_list) -> List:
    """Per source, whether its chunks upload as CSR triplets: a CSR source
    whose largest chunk's triplets are < 70% of its dense bytes does (its
    ``cap``, value dtype and column dtype); every other source uploads
    dense rows (None)."""
    plans = []
    for src in feeder.sources:
      indptr = getattr(src, "indptr", None)
      if indptr is None:
        plans.append(None)
        continue
      d = src.shape[1]
      nnz_per_row = np.diff(indptr)
      cap = max(int(nnz_per_row[rows].sum()) for rows in chunk_rows_list)
      cap = max(8, -(-cap // 8) * 8)
      val_bytes = 2 if self.device_dtype in ("int16", "bfloat16") else 4
      itemsize = 4 if self.device_dtype == "float32" else 2
      if not worthwhile(cap, len(chunk_rows_list[0]), d, val_bytes,
                        itemsize):
        plans.append(None)
        continue
      if self.device_dtype == "int16" and not int16_exact(src.data):
        raise ValueError(_INT16_MESSAGE)
      plans.append({"cap": cap, "val_dtype": _DEVICE_DTYPES[
          self.device_dtype], "col_dtype": col_dtype_for(d)})
    return plans

  def _fit_out_of_core(self, model, train_feeder, valid_feeder, epochs,
                       callbacks, checkpoint_fn):
    """Rows randomly partitioned into equal chunks (one permutation for the
    run; the chunk order and each chunk's rows are shuffled every epoch:
    the windowed approximation of a full shuffle). Resident chunks upload
    once; streamed ones through a one-worker pipeline, so the host work
    and upload of the next chunk overlap the training of this one. The
    last chunk wraps around the permutation to keep the chunk size."""
    plan = self._plan_out_of_core(train_feeder)
    n, B = int(train_feeder.n_obs), int(train_feeder.batch_size)
    self._check_mesh_batch(B)
    R, S, K = plan["chunk_rows"], plan["n_chunks"], plan["n_resident"]
    dev = model.device
    gen = model.generator
    perm = np.random.default_rng(_host_seed(gen)).permutation(n)
    perm = perm.astype(np.int64)
    chunk_rows_list = []
    for c in range(S):
      rows = perm[c * R:(c + 1) * R]
      if len(rows) < R:
        rows = np.concatenate([rows, perm[:R - len(rows)]])
      chunk_rows_list.append(rows)
    lib_full = train_feeder.library
    splans = self._sparse_chunk_plans(train_feeder, chunk_rows_list)
    store = _DEVICE_DTYPES[self.device_dtype]
    if self.device_dtype == "int16":
      # validate each dense-planned source once: the per-epoch uploads
      # then skip the O(rows × genes) scan of unchanged data
      for src, p in zip(train_feeder.sources, splans):
        if p is None and not int16_exact(src.values()):
          raise ValueError(_INT16_MESSAGE)
    transfer = _Transfer(dev)

    def host_chunk(c: int):
      """A chunk's host work: dense rows, or CSR triplets, pinned."""
      rows = chunk_rows_list[c]
      parts = []
      for src, p in zip(train_feeder.sources, splans):
        if p is None:
          parts.append((None, transfer.pin(
              self._densify_rows(src, rows, validate=False))))
          continue
        # sparse upload: triplets over the link, scatter on the device
        vals, cols, rowlen = csr_row_triplets(
            src.indptr, src.indices, src.data, rows, p["cap"], R,
            np.int16 if store == torch.int16 else np.float32, p["col_dtype"])
        if cols.dtype == np.uint16:
          cols = cols.view(np.int16)  # see ops/sparse.column_ids
        parts.append((src.shape[1], [transfer.pin(t) for t in (
            torch.from_numpy(vals).to(store), torch.from_numpy(cols),
            torch.from_numpy(rowlen))]))
      lib = transfer.pin(lib_full[rows]) if lib_full is not None else None
      return parts, lib

    def device_chunk(parts, lib):
      xs = [transfer.upload(t) if d is None else densify(*t, d, store, dev)
            for d, t in parts]
      return xs, None if lib is None else transfer.upload(lib)

    def prepare(c: int, after=None):
      """Chunk ``c`` on the device. ``after``: the event that ends the
      steps of the chunk streamed two before this one; its memory is
      reused only once they have run, so the double buffer holds two
      chunks however far the host runs ahead of the card."""
      host = host_chunk(c)
      if after is not None:
        after.synchronize()
      return transfer.put(lambda: device_chunk(*host))

    if self.verbose:
      gb = self._bytes_per_row(train_feeder) * n / 1024 ** 3
      n_sparse = sum(p is not None for p in splans)
      print(f"[trainer] out-of-core: {n:,} cells ({gb:.1f} GB dense) in "
            f"{S} chunks × {R:,} rows — {K} resident on the device, "
            f"{S - K} streamed per epoch"
            + (f" ({n_sparse}/{len(splans)} sources upload sparse)"
               if n_sparse else ""))
    resident = {c: transfer.take(prepare(c), _chunk_tensors)
                for c in range(K)}
    mask_all = (torch.rand((R,), generator=gen, device=dev)
                < train_feeder.labels_percent).to(torch.float32)
    steps_per_epoch = S * (R // B)
    self._oc_plan = dict(plan, sparse_sources=[p is not None
                                               for p in splans])
    best = _Best(model)
    if self.max_iter and model.step >= self.max_iter:
      epochs = 0  # warm-started past the step budget: train nothing
    order_rng = np.random.default_rng(_host_seed(gen) ^ 0x5CA1AB1E)
    keys = None
    done = None  # the event after the last streamed chunk's steps
    executor = ThreadPoolExecutor(max_workers=1)
    try:
      for epoch in range(epochs):
        logs: Dict[str, float] = {}
        for cb in callbacks:
          cb.on_epoch_begin(epoch, logs)
        order = order_rng.permutation(S)
        streamed = [int(c) for c in order if c >= K]
        fut = (executor.submit(prepare, streamed[0], done)
               if streamed else None)
        si, waited, acc = 0, 0.0, None
        t0 = time.perf_counter()
        for c in order:
          if c < K:
            xs_c, lib_c = resident[c]
          else:
            t_wait = time.perf_counter()
            xs_c, lib_c = transfer.take(fut.result(), _chunk_tensors)
            waited += time.perf_counter() - t_wait
            si += 1
            fut = (executor.submit(prepare, streamed[si], done)
                   if si < len(streamed) else None)
          acc, keys = self._epoch_steps(model, xs_c, lib_c, mask_all, B, acc,
                                        keys)
          if c >= K:
            done = transfer.mark()
          # a streamed chunk's memory returns to the allocator once the
          # steps enqueued on it have run (record_stream)
          del xs_c, lib_c
        sums = acc.cpu().numpy()
        dt = time.perf_counter() - t0
        self._oc_wait_s.append(waited)
        logs.update({k: float(v) / steps_per_epoch
                     for k, v in zip(keys, sums)})
        logs["epoch_time"] = dt
        logs["cells_per_sec"] = steps_per_epoch * B / max(dt, 1e-9)
        if valid_feeder is not None:
          logs.update({f"val_{k}": v for k, v in
                       self.evaluate(model, valid_feeder).items()})
        if (self._end_epoch(model, epoch, logs, callbacks, checkpoint_fn,
                            best, f"({dt:.2f}s)")
            or (self.max_iter and model.step >= self.max_iter)):
          break  # epoch-granular, as the JAX loop
    finally:
      executor.shutdown(wait=True)
    for cb in callbacks:
      cb.on_train_end(dict(self.history))

  # ------------------------------------------------------------------ eval
  def evaluate(self, model, feeder) -> Dict[str, float]:
    """Mean metrics over ``feeder`` (eval mode, mask = 1). Under
    ``device_cache``, when the data costs at most an eighth of the budget,
    the feeder is uploaded once and evaluated on the device
    (``model._evaluate``); else its batches stream, as the JAX rule. On a
    data mesh the batches stream, each rank evaluating its rows (a batch
    of fewer rows than ranks: every rank all of it), and the means are
    global."""
    n_data = self._n_data()
    if (self.device_cache and n_data == 1
        and feeder.n_obs >= feeder.batch_size
        and self._bytes_per_row(feeder) * feeder.n_obs
        <= self._device_budget() // 8):
      if self._eval_cache is None or self._eval_cache[0] is not feeder:
        dev = model.device
        xs = [src.t.to(device=dev, dtype=torch.float32)
              if isinstance(src, _TensorSource) else
              torch.from_numpy(src.gather(
                  np.arange(src.shape[0]),
                  np.empty(src.shape, np.float32))).to(dev)
              for src in feeder.sources]
        lib = (torch.from_numpy(feeder.library).to(dev)
               if feeder.library is not None else None)
        self._eval_cache = (feeder, xs, lib)
      return model._evaluate(*self._eval_cache[1:],
                             batch_size=feeder.batch_size)
    dev = model.device
    acc, keys, n = None, None, 0
    for batch in feeder.full_batches():
      b = batch["inputs"][0].shape[0]
      lo, hi = PF.local_rows(b) if b >= n_data else (0, b)
      dev_batch = {"inputs": [torch.from_numpy(x[lo:hi]).to(dev)
                              for x in batch["inputs"]],
                   "mask": torch.from_numpy(batch["mask"][lo:hi]).to(dev)}
      if "library" in batch:
        dev_batch["library"] = torch.from_numpy(
            batch["library"][lo:hi]).to(dev)
      if b >= n_data:
        with PF.batch_rows(b, lo, hi):
          metrics = model._eval_step(dev_batch)
      else:
        metrics = model._eval_step(dev_batch)
      if keys is None:
        keys = sorted(metrics)
      vec = torch.stack([metrics[k].float() for k in keys]) * b
      acc = vec if acc is None else acc + vec
      n += b
    return {k: float(v) / n for k, v in zip(keys, acc.cpu().numpy())}
