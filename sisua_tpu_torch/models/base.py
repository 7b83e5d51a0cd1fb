"""SingleCellModel — keras-feel wrapper over the torch VAE modules (port of
``sisua_tpu/models/base.py``).

The fit half: ``__init__``, ``_loss``, the train and eval steps, ``fit``
with validation and early stopping, and ``evaluate``. The serving half:
``apply``/``encode``/``decode``, ``predict`` (streaming, or
``device_cache=True``), ``predict_mean``, ``get_normalized_expression``,
``compute_llk`` and ``marginal_log_prob``, over serving chunks sized to
the card's memory. Checkpoints: ``save_weights``/``load_weights`` write
and read the JAX package's files (``train/checkpoint.py``), so a model
saved by either package loads in the other (``models.load_model``).

Hooks for the zoo, as in the JAX package: ``_init_aux`` builds a second
parameter group (FactorVAE's discriminator) with its own optimizer
(``_make_aux_optimizer``); ``_extra_loss`` adds a term to the loss;
``_aux_step`` runs after the main optimizer step. The aux parameters are
outside the main optimizer and its gradient clip, are written to
``aux_params.msgpack``, and a rollback restores them with their optimizer
state.

The model owns an ``nn.Module`` on an explicit ``device`` (default
``"cuda"``, which raises when there is no card), a ``torch.Generator`` on
that device for the reparameterization noise, dropout masks, the epoch
permutation and the semi-supervised mask, its Adam state and a step
counter. Parameters are initialized on the CPU from the seed and then
moved, so the initial weights do not depend on the device. Data is one
matrix or a list ``[rna, adt, …]`` (one per output; numpy, scipy or
tensor) or a ``DataFeeder``; the first feeds the encoder and the rest are
label targets. With batch-covariate conditioning
(``n_batch`` > 0) the LAST matrix is the per-cell batch one-hot, appended
to the encoder input (``_module_input``); ``_batch_onehot`` builds it from
a container's ``obs[batch_key]``. Serving reads only the matrices the
encoder consumes. ``fit`` takes the JAX package's training surface:
``optimizer`` (the seven optax optimizers), ``mc_samples``,
``track_gradient_norms``, ``freeze`` (and ``fit_query``), ``callbacks``,
``checkpoint_path``, ``device_dtype``, ``transfer_dtype``,
``hbm_budget_bytes`` and ``profile_dir``, and its three loops (streaming,
device-resident, out of core: ``train/trainer.py``); with
``compute_dtype='bfloat16'`` the model trains in mixed precision. Serving
uploads a CSR matrix as triplets where they are clearly smaller than its
dense block. ``differential_expression`` draws its scales on the device
and computes its statistics there in float64. ``create_posterior``
builds the analysis hub (``analysis.Posterior``) on arrays.

``mesh=`` (a ``parallel.create_mesh`` of the calling world; every rank
makes the same call): ``fit`` trains one global step per batch over the
'data' axis, with wide leaves split over 'model' (``parallel/
functional.py``), and returns with the whole model on every rank; the
serving calls round the batch up to a multiple of n_data, serve each
rank's rows and all-gather the outputs in cell order, so every rank
returns the single-device arrays. Checkpoints are written by rank 0.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import math
import os
import re
import warnings
from typing import (Dict, Iterator, List, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch
from scipy import sparse
from torch import nn

from .. import convert
from .. import dist as D
from ..data.feeder import DataFeeder
from ..data.utils import get_library_size, int16_exact
from ..interpolation import Interpolation, get_interpolation
from ..nn import DropoutMasks, NetConf, parse_netconf, resolve_dtype
from ..ops.sparse import col_dtype_for, csr_row_triplets, densify, worthwhile
from ..parallel import functional as PF
from ..parallel.mesh import device_memory_limit
from ..rv import RVmeta, parse_rv
from ..train import checkpoint as ckpt
from ..train.trainer import Trainer, TrainingCallback
from .module import VAEModule, VAEOutput
from .objective import compute_loss, mc_row_log_prob

__all__ = ["SingleCellModel", "resolve_device"]

UNIVERSAL_RANDOM_SEED = 5218  # sisua_tpu.data.const
#: the serving budget, a share of the card's memory (the JAX package's)
SERVING_BUDGET_FRACTION = 0.35
_NUMPY_DTYPES = {torch.float32: np.float32, torch.int16: np.int16}


def _flatten(x) -> Tuple:
  if x is None:
    return ()
  if isinstance(x, (tuple, list)):
    return tuple(x)
  return (x,)


def _to_snake_case(name: str) -> str:
  """keras' auto-name (the JAX package's default model name)."""
  s = re.sub(r"(.)([A-Z][a-z0-9]+)", r"\1_\2", name)
  return re.sub(r"([a-z])([A-Z])", r"\1_\2", s).lower()


def _as_shape(sample_shape) -> Tuple[int, ...]:
  return ((int(sample_shape),) if isinstance(sample_shape, int)
          else tuple(int(s) for s in sample_shape))


def resolve_device(device) -> torch.device:
  """``torch.device``; a CUDA device must exist (no silent CPU fallback)
  and gets its index ('cuda' → 'cuda:0'), so it compares equal to a
  tensor's device. On CUDA, TF32 is switched off for matmuls and cuDNN: the
  port is held to the JAX package in float32, and TF32 keeps about three
  digits."""
  device = torch.device(device)
  if device.type == "cuda":
    if not torch.cuda.is_available():
      raise RuntimeError("device='cuda' but torch.cuda.is_available() is "
                         "False; pass device='cpu' explicitly")
    if device.index is None:
      device = torch.device("cuda", torch.cuda.current_device())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
  return device


def _as_device_matrix(a, device) -> torch.Tensor:
  if isinstance(a, torch.Tensor):
    return a.to(device=device, dtype=torch.float32)
  if hasattr(a, "toarray"):  # scipy sparse
    a = a.toarray()
  return torch.as_tensor(np.asarray(a, np.float32), device=device)


def _merge_batch_leaves(axis: int, n: Optional[int] = None,
                        batch: Optional[int] = None):
  """``tree_map`` reducer that concatenates per-batch distribution leaves
  along ``axis`` (then keeps the first ``n`` rows: padded batches), EXCEPT
  batch-invariant parameter rows such as SCVI's 'single' per-gene (1, D)
  dispersion, which every batch returns identically: stacking k copies
  makes a phantom (k, D) leaf whose broadcast against the (N, D) mean
  fails. Constants have a singleton leading dim (they never gain MC sample
  dims) and are equal across batches. On the device-cached path
  (``batch``, the padded batch size) a (1, D) leaf is a constant whenever
  ``batch`` > 1, a single batch included, as the JAX package's stacked
  (k, 1, D) rule; the streaming rule needs two equal batches."""
  def merge(*xs):
    x0 = xs[0]
    if batch is None:
      const = len(xs) > 1 and x0.ndim >= 1 and x0.shape[0] == 1
    else:
      const = x0.ndim == 2 and x0.shape[0] == 1 and batch != 1
    if const and all(x.shape == x0.shape and torch.equal(x0, x)
                     for x in xs[1:]):
      return x0
    out = torch.cat(xs, dim=axis)
    return out if n is None else out.narrow(axis, 0, n)
  return merge


def _merge_dists(dists_per_batch, axis: int, **kw) -> Tuple:
  """Merge every batch's tuple of distributions, position by position."""
  return tuple(D.tree_map(_merge_batch_leaves(axis, **kw), *ds)
               for ds in zip(*dists_per_batch))


def _gathered_dists(dists, axis: int, k: int, b: int, n: int) -> Tuple:
  """A mesh rank's merged distributions of k batches (b of its rows each
  along ``axis``) → every rank's, in cell order, trimmed to ``n``; a
  per-gene (1, D) row stays as it is."""
  def gather(t):
    const = t.ndim == 2 and t.shape[0] == 1  # _merge_batch_leaves' rule
    if not const and t.ndim > axis and t.shape[axis] == k * b:
      t = PF.gather_batches(t, k, axis)
      t = t.narrow(axis, 0, n)
    return t
  return tuple(D.tree_map(gather, d) for d in dists)


def _gathered_rows(dists, axis: int, rows: int) -> Tuple:
  """A mesh rank's distributions of its ``rows`` rows of one batch (cells
  on ``axis``) → the batch's, every rank's rows in order; a per-gene
  (1, D) row stays as it is. Without a split batch, as they are."""
  def gather(t):
    const = t.ndim == 2 and t.shape[0] == 1 and rows != 1
    if not const and t.ndim > axis and t.shape[axis] == rows:
      return PF.gather_rows(t, axis)
    return t
  return tuple(D.tree_map(gather, d) for d in dists)


def _to_host(dists) -> Tuple:
  return tuple(D.tree_map(lambda t: t.cpu(), d) for d in dists)


def _one_or_tuple(xs):
  return xs if len(xs) > 1 else xs[0]


def _take_rows(data, idx: np.ndarray):
  """The rows ``idx`` of one matrix or of each in a list (numpy, scipy or
  tensor, a tensor gathered where it lies)."""
  def take(m):
    if isinstance(m, torch.Tensor):
      return m.index_select(0, torch.as_tensor(idx, device=m.device))
    return m[idx]
  if isinstance(data, (tuple, list)):
    return [take(m) for m in data]
  return take(data)


_DE_EPS = 1e-10


def _de_stats_numpy(s1: np.ndarray, s2: np.ndarray, i1: np.ndarray,
                    i2: np.ndarray, mode: str, delta: float
                    ) -> Dict[str, np.ndarray]:
  """The JAX package's DE statistics, statement for statement: (S·m, d)
  float64 draws of each group and the pair indices."""
  a, b = s1[i1], s2[i2]
  eps = _DE_EPS
  out = {"scale1": s1.mean(0), "scale2": s2.mean(0)}
  if mode == "vanilla":
    p = (a > b).mean(0)
    out["proba_m1"] = p
    out["bayes_factor"] = np.log(p + eps) - np.log1p(eps - p)
  else:
    lfc = np.log2(a + eps) - np.log2(b + eps)
    p = (np.abs(lfc) > float(delta)).mean(0)
    out.update(proba_de=p,
               bayes_factor=np.log(p + eps) - np.log1p(eps - p),
               lfc_mean=lfc.mean(0), lfc_median=np.median(lfc, 0),
               lfc_std=lfc.std(0))
  return out


def _pair_share(hits: torch.Tensor) -> torch.Tensor:
  """The share of pairs per gene, divided as numpy's mean divides: on the
  card, torch's mean and a division by a Python number multiply by 1/n,
  an ulp off; a tensor divisor divides."""
  count = torch.sum(hits, 0, dtype=torch.float64)
  return count / torch.full_like(count, hits.shape[0])


def _de_stats_torch(s1: torch.Tensor, s2: torch.Tensor, i1: np.ndarray,
                    i2: np.ndarray, mode: str, delta: float
                    ) -> Dict[str, np.ndarray]:
  """``_de_stats_numpy`` in float64 on the draws' device; only the
  per-gene results are fetched. The median of an even count is the mean
  of the two middle values, as ``np.median``'s."""
  from ..analysis.imputation import _median
  dev = s1.device
  a = s1.index_select(0, torch.as_tensor(i1, device=dev))
  b = s2.index_select(0, torch.as_tensor(i2, device=dev))
  eps = _DE_EPS
  out = {"scale1": s1.mean(0), "scale2": s2.mean(0)}
  if mode == "vanilla":
    p = _pair_share(a > b)
    out["proba_m1"] = p
    out["bayes_factor"] = torch.log(p + eps) - torch.log1p(eps - p)
  else:
    lfc = torch.log2(a + eps) - torch.log2(b + eps)
    del a, b
    p = _pair_share(torch.abs(lfc) > float(delta))
    out.update(proba_de=p,
               bayes_factor=torch.log(p + eps) - torch.log1p(eps - p),
               lfc_mean=lfc.mean(0), lfc_median=_median(lfc, 0),
               lfc_std=lfc.std(0, correction=0))
  return {k: v.cpu().numpy() for k, v in out.items()}


def _state_copy(module: nn.Module) -> Dict[str, torch.Tensor]:
  return {k: v.detach().clone() for k, v in module.state_dict().items()}


class SingleCellModel:
  """Base class of the port's zoo. Subclasses customize via ctor."""

  module_cls = VAEModule
  #: multitask semi-supervised masking of non-primary outputs (SISUA family)
  mask_outputs: bool = False
  #: leading data matrices the encoder reads (TotalVI's RNA + proteins,
  #: MULTIVI's RNA + peaks: 2); the rest are label targets
  n_input_sources: int = 1

  def __init__(self,
               outputs: Union[RVmeta, Sequence[RVmeta]],
               latents: Union[RVmeta, Sequence[RVmeta], None] = None,
               encoder: Union[NetConf, Sequence[NetConf], None] = None,
               decoder: Union[NetConf, Sequence[NetConf], None] = None,
               log_norm: bool = True,
               beta: Union[float, Interpolation] = 1.0,
               alpha: float = 1.0,
               gamma: float = 1.0,
               analytic: bool = True,
               mask_renorm: bool = False,
               reduce_latent: str = "concat",
               compute_dtype: Optional[str] = None,
               seed: int = UNIVERSAL_RANDOM_SEED,
               dataset: Optional[str] = None,
               metadata: Optional[Dict] = None,
               name: Optional[str] = None,
               batch_key: str = "batch",
               prng: str = "rbg",
               device: Union[str, torch.device] = "cuda",
               **module_kwargs):
    """The JAX package's constructor (every kwarg its ``metamodel.json``
    records), plus ``device``. ``prng`` names the JAX generator and is
    only recorded: the port draws from a ``torch.Generator``. ``gamma``
    (FactorVAE's TC weight) and ``batch_key`` are recorded for the
    checkpoint. ``compute_dtype='bfloat16'`` is mixed precision as in the
    JAX package: the encoder and decoder MLPs and the heads' matmuls run
    in bf16, while parameters, BatchNorm statistics and every log-prob
    stay float32 (``nn.py``)."""
    resolve_dtype(compute_dtype)  # raises on an unknown name
    outputs = tuple(parse_rv(o, f"output{i}")
                    for i, o in enumerate(_flatten(outputs)))
    if latents is None:
      latents = RVmeta(10, "diag", True, "latents")
    latents = tuple(parse_rv(z, f"latent{i}")
                    for i, z in enumerate(_flatten(latents)))
    if encoder is None:
      encoder = NetConf((64, 64), batchnorm=True, input_dropout=0.3,
                        name="encoder")
    encoder = tuple(parse_netconf(e, f"encoder{i}")
                    for i, e in enumerate(_flatten(encoder)))
    if decoder is None:
      decoder = NetConf((64, 64), batchnorm=True, name="decoder")
    decoder = tuple(parse_netconf(d, f"decoder{i}")
                    for i, d in enumerate(_flatten(decoder)))
    if compute_dtype:
      encoder = tuple(e.replace(compute_dtype=compute_dtype) for e in encoder)
      decoder = tuple(d.replace(compute_dtype=compute_dtype) for d in decoder)
    self.compute_dtype = compute_dtype
    self.outputs, self.latents = outputs, latents
    self.encoder, self.decoder = encoder, decoder
    self.log_norm = bool(log_norm)
    self.beta = get_interpolation(beta)
    self.alpha = float(alpha)
    self.gamma = float(gamma)
    self.analytic = bool(analytic)
    self.mask_renorm = bool(mask_renorm)
    self.reduce_latent = reduce_latent
    self.seed = int(seed)
    self.prng = str(prng)
    self.dataset = dataset
    self.metadata = metadata or {}
    self.batch_key = str(batch_key)
    self._name = name or _to_snake_case(type(self).__name__)
    self.device = resolve_device(device)
    init_gen = torch.Generator().manual_seed(self.seed)
    self.module = self.module_cls(
        self.outputs, self.latents, self.encoder, self.decoder,
        log_norm=self.log_norm, reduce_latent=reduce_latent,
        generator=init_gen, **module_kwargs).to(self.device)
    self.module.set_compute_dtype(compute_dtype)
    self.aux = self._init_aux(init_gen)
    if self.aux is not None:
      self.aux.to(self.device)
    self.aux_optimizer = None
    self.generator = torch.Generator(device=self.device)
    self.generator.manual_seed(self.seed)
    self.step = 0
    self.optimizer = None
    self._last_freeze: Tuple[str, ...] = ()
    self._train_mc_samples = 1
    self._track_grad_norms = False
    self.trainer: Optional[Trainer] = None
    self._loaded_history: Dict[str, List[float]] = {}
    #: a mesh fit's model axis (``parallel.functional.ModelSplit``)
    self._split = None
    # a constant β round-trips as its value, a warm-up schedule whole
    beta_spec = (self.beta.vmax if self.beta.kind == "const"
                 and not self.beta.cyclical else
                 dataclasses.asdict(self.beta))
    self._init_kwargs_for_save = dict(
        outputs=outputs, latents=latents, encoder=encoder, decoder=decoder,
        log_norm=log_norm, beta=beta_spec, alpha=alpha, gamma=gamma,
        analytic=analytic, mask_renorm=mask_renorm,
        reduce_latent=reduce_latent, compute_dtype=compute_dtype,
        seed=seed, name=self._name, batch_key=batch_key, prng=self.prng,
        **module_kwargs)

  def set_metadata(self, sco) -> "SingleCellModel":
    """Record the dataset name and per-omic var_names (duck-typed on
    ``.name``, ``.omics`` and ``.get_var_names``); ``save_weights``
    writes them into ``metamodel.json``."""
    self.dataset = sco.name
    for om in sco.omics:
      self.metadata[str(om)] = list(np.asarray(sco.get_var_names(om),
                                               dtype=str))
    return self

  # ---------------------------------------------------------------- naming
  @property
  def name(self) -> str:
    return self._name

  @property
  def id(self) -> str:
    """Lower-cased capital letters of the class name ('dca', 'scvi')."""
    return "".join(c for c in type(self).__name__ if c.isupper()).lower()

  @property
  def uses_library(self) -> bool:
    """Whether the module consumes the per-cell library stats (SCVI)."""
    return False

  @property
  def n_batch(self) -> int:
    """Batch-covariate conditioning cardinality (0 = off)."""
    return self.module.n_batch

  @property
  def is_semi_supervised(self) -> bool:
    return self.mask_outputs and len(self.outputs) > 1

  @property
  def is_zero_inflated(self) -> bool:
    return self.outputs[0].is_zero_inflated

  @property
  def posteriors(self) -> Tuple[RVmeta, ...]:
    return self.outputs

  @property
  def n_outputs(self) -> int:
    return len(self.outputs)

  @property
  def n_latents(self) -> int:
    return len(self.latents)

  @property
  def history(self) -> Dict[str, List[float]]:
    if self.trainer is not None:
      return self.trainer.history
    return self._loaded_history

  # -------------------------------------------------------------- loss/step
  def _module_input(self, inputs: Sequence[torch.Tensor]) -> torch.Tensor:
    """The encoder's input: the first ``n_input_sources`` omics side by
    side (the main one alone for most models); the rest are labels. With
    batch conditioning a trailing matrix of width ``n_batch`` is the batch
    one-hot and is appended (the module splits it back off)."""
    k = self.n_input_sources
    if len(inputs) < k:
      raise ValueError(f"{type(self).__name__} needs {k} input matrices, "
                       f"got {len(inputs)}")
    parts = list(inputs[:k])
    if self.n_batch and len(inputs) > k \
        and inputs[-1].shape[-1] == self.n_batch:
      parts.append(inputs[-1])
    if len(parts) == 1:
      return parts[0]
    return torch.cat([parts[0]] + [p.to(parts[0].dtype) for p in parts[1:]],
                     dim=-1)

  def _masked_module_input(self, batch, training: bool) -> torch.Tensor:
    """The training-time module input. A model whose encoder reads a
    semi-supervised omic (TotalVI's proteins) zeroes it for unlabeled
    cells here, or the encoder would see what the mask hides."""
    return self._module_input(batch["inputs"])

  def _serving_source_indices(self, n_sources: int) -> List[int]:
    """The matrices ``_module_input`` consumes, in order: serving uploads
    only these (a SISUA model serves from the RNA matrix alone); the
    trailing batch one-hot stays trailing."""
    idx = list(range(self.n_input_sources))
    if self.n_batch and n_sources > self.n_input_sources:
      idx.append(n_sources - 1)
    return idx

  def _batch_onehot(self, sco) -> np.ndarray:
    """Per-cell batch one-hot (n_obs, n_batch) from ``sco.obs[batch_key]``
    (duck-typed on ``sco.obs`` and ``sco.n_obs``), to pass as the last
    data matrix. The level→code map is fixed by the first data seen and
    kept in ``metadata['batch_categories']`` (so in the checkpoint):
    later data with a subset of the levels gets the same codes, unseen
    levels are appended while ``n_batch`` has room, else it raises. A
    missing column warns and puts every cell in batch 0."""
    nb = self.n_batch
    if not nb:
      raise ValueError("the model has no batch conditioning (n_batch=0)")
    if self.batch_key not in sco.obs:
      warnings.warn(f"batch conditioning is on (n_batch={nb}) but "
                    f"obs['{self.batch_key}'] is absent; assuming one batch")
      return np.eye(nb, dtype=np.float32)[np.zeros(sco.n_obs, np.int64)]
    col = [str(v) for v in np.asarray(sco.obs[self.batch_key])]
    uniq = [str(v) for v in self.metadata.get("batch_categories", [])]
    unseen = sorted(set(col) - set(uniq))
    if unseen:
      if len(uniq) + len(unseen) > nb:
        raise ValueError(
            f"obs['{self.batch_key}'] carries {len(unseen)} level(s) beyond "
            f"the {len(uniq)} known ones; total exceeds n_batch={nb}")
      uniq = uniq + unseen
      self.metadata["batch_categories"] = list(uniq)
    idx = {v: i for i, v in enumerate(uniq)}
    codes = np.array([idx[v] for v in col], np.int64)
    return np.eye(nb, dtype=np.float32)[codes]

  def _loss(self, batch, training: bool, beta: float,
            noise: Optional[Sequence[Optional[torch.Tensor]]] = None,
            masks: Optional[DropoutMasks] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], VAEOutput]:
    """−ELBO of one batch {inputs: [x, …], library?, mask?}, plus the
    ``_extra_loss`` term when there is one. The module is put in train or
    eval mode (BatchNorm batch vs running stats, dropout); in train mode
    BatchNorm updates its running stats. The mask gates the label heads
    only in training; the missing-modality gates (``_output_masks``,
    ``_latent_masks``) in training and evaluation alike. ``masks`` gives
    the dropout masks in place of the model's generator (the ensemble's
    step under ``torch.func.vmap``), ``beta`` may be a tensor there."""
    self.module.train(training)
    library = batch.get("library") if self.uses_library else None
    # training-time MC (``mc_samples``): S reparameterized draws per cell,
    # averaged over the leading sample dim by the ELBO
    mc = self._train_mc_samples if training else 1
    out = self.module(self._masked_module_input(batch, training),
                      library=library,
                      generator=self.generator if masks is None else masks,
                      noise=noise, sample_shape=(mc,) if mc > 1 else ())
    loss, metrics = compute_loss(
        out, self._loss_targets(batch), mask=batch.get("mask"), beta=beta,
        alpha=self.alpha, analytic=self.analytic,
        mask_outputs=self.mask_outputs if training else False,
        mask_renorm=self.mask_renorm if training else False,
        output_masks=self._output_masks(batch),
        latent_masks=self._latent_masks(batch))
    extra = self._extra_loss(out, batch, training)
    if extra is not None:
      loss = loss + extra[0]
      metrics.update(extra[1])
      metrics["loss"] = loss
    return loss, metrics, out

  # ------------------------------------------------------------------ hooks
  def _loss_targets(self, batch) -> Sequence[torch.Tensor]:
    """Likelihood targets, one per output (PEAKVI and MULTIVI binarize the
    accessibility counts)."""
    return batch["inputs"]

  def _output_masks(self, batch) -> Optional[Sequence[Optional[torch.Tensor]]]:
    """None, or per-output (B,) likelihood gates for cells missing that
    modality (MULTIVI's all-zero rows)."""
    return None

  def _latent_masks(self, batch) -> Optional[Sequence[Optional[torch.Tensor]]]:
    """None, or per-latent (B,) KL gates: a latent encoded from a modality
    a cell lacks charges that cell no KL (MULTIVI's library)."""
    return None

  def _init_aux(self, generator: torch.Generator) -> Optional[nn.Module]:
    """A second parameter group, initialized from ``generator`` (the
    module's init stream), or None (FactorVAE overrides)."""
    return None

  def _make_aux_optimizer(self):
    """The aux group's own optimizer (FactorVAE overrides)."""
    raise NotImplementedError(f"{type(self).__name__} has aux parameters "
                              "but no optimizer for them")

  def _extra_loss(self, out: VAEOutput, batch, training: bool
                  ) -> Optional[Tuple[torch.Tensor, Dict[str, torch.Tensor]]]:
    """None, or (term, metrics): the term is added to the loss and the
    metrics to the step's (FactorVAE's γ·TC). The aux parameters must not
    receive a gradient from it."""
    return None

  def _aux_step(self, batch, metrics: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
    """Runs after the main optimizer step; returns the step's metrics
    (FactorVAE trains its discriminator here)."""
    return metrics

  def _aux_plan(self, batch, recorder) -> None:
    """Records the aux step's draws in ``recorder`` (a ``NoiseRecorder``),
    for ``VmapEnsemble``, which batches the aux step over members as
    ``_aux_loss`` and one Adam step of the aux optimizer's settings
    (FactorVAE overrides both)."""
    raise NotImplementedError(f"{type(self).__name__}'s aux step has no "
                              "form VmapEnsemble can batch")

  def _aux_loss(self, batch, draws) -> torch.Tensor:
    """The aux group's loss at the module's current state from the draws
    ``_aux_plan`` recorded: what ``_aux_step`` descends."""
    raise NotImplementedError(f"{type(self).__name__}'s aux step has no "
                              "form VmapEnsemble can batch")

  def _gathered(self):
    """The model axis's full leaves for a step (a mesh fit), else
    nothing to do."""
    split = self._split
    return split.gathered() if split is not None else contextlib.nullcontext()

  def _train_step(self, batch, noise=None) -> Dict[str, torch.Tensor]:
    """One optimizer step; β is the schedule at the current step. Then the
    aux step, on the updated parameters. Every parameter gets its gradient,
    frozen ones too (the optimizer holds the trainable ones only); with
    ``track_gradient_norms`` the pre-clip global norm over all of them is
    the step's ``grad_norm``, as ``optax.global_norm(grads)``. ``noise``
    feeds the forward's draws (tests). In a mesh fit the gradients are
    summed over 'data' before the clip (each rank's loss is its share of
    the global batch's) and the norm counts split leaves once."""
    with self._gathered():
      loss, metrics, _ = self._loss(batch, True, self.beta(self.step),
                                    **({} if noise is None
                                       else {"noise": noise}))
      self.module.zero_grad(set_to_none=True)
      loss.backward()
    params = list(self.module.parameters())
    PF.all_reduce_grads(params)
    if self._track_grad_norms:
      metrics["grad_norm"] = PF.global_grad_norm(
          params, None if self._split is None else self._split.ids)
    self.optimizer.step()
    self.step += 1
    with self._gathered():
      return self._aux_step(batch, metrics)

  def _eval_step(self, batch) -> Dict[str, torch.Tensor]:
    with torch.no_grad(), self._gathered():
      _, metrics, _ = self._loss(batch, False, self.beta(self.step))
    return metrics

  def _snapshot(self) -> Dict:
    """Device-side copy of parameters, buffers, Adam state and step, and
    of the aux parameters and their optimizer's state (the JAX rollback
    restores the whole ``TrainState``)."""
    snap = {"module": _state_copy(self.module),
            "optimizer": copy.deepcopy(self.optimizer.state_dict()),
            "step": self.step}
    if self.aux is not None:
      snap["aux"] = _state_copy(self.aux)
      snap["aux_optimizer"] = copy.deepcopy(self.aux_optimizer.state_dict())
    return snap

  def _restore(self, snap: Dict) -> None:
    self.module.load_state_dict(snap["module"])
    self.optimizer.load_state_dict(snap["optimizer"])
    self.step = snap["step"]
    if self.aux is not None:
      self.aux.load_state_dict(snap["aux"])
      self.aux_optimizer.load_state_dict(snap["aux_optimizer"])

  # --------------------------------------------------------------- forward
  @contextlib.contextmanager
  def _batch_stats_kept(self, training: bool):
    """flax's non-mutable apply in train mode: BatchNorm normalizes with
    the batch statistics, and its running stats are put back afterwards
    (the port's ``BatchNorm`` updates them whenever it trains)."""
    saved = ({k: b.clone() for k, b in self.module.named_buffers()}
             if training else None)
    try:
      yield
    finally:
      if saved:
        with torch.no_grad():
          for k, b in self.module.named_buffers():
            b.copy_(saved[k])

  def apply(self, x, library=None, training: bool = False,
            sample_shape: Tuple[int, ...] = (),
            noise: Optional[Sequence[Optional[torch.Tensor]]] = None,
            mutable: bool = False):
    """Raw module application → ``VAEOutput``. ``training=True`` uses the
    batch statistics and dropout but leaves the running stats as they
    were, unless ``mutable``: then they are updated, and ``(out,
    batch_stats)`` comes back with the running buffers by name. ``noise``
    feeds the reparameterization draws (one standard-normal tensor per
    latent), else they come from the model's generator."""
    x = _as_device_matrix(x, self.device)
    if library is not None:
      library = _as_device_matrix(library, self.device)
    self.module.train(training)
    with self._batch_stats_kept(training and not mutable):
      out = self.module(x, library=library if self.uses_library else None,
                        sample_shape=_as_shape(sample_shape),
                        generator=self.generator, noise=noise)
    if mutable:
      return out, dict(self.module.named_buffers())
    return out

  def __call__(self, x, library=None, training=False, sample_shape=()):
    return self.apply(x, library=library, training=training,
                      sample_shape=sample_shape)

  def encode(self, x, library=None, training: bool = False,
             sample_shape: Tuple[int, ...] = ()):
    """q(Z|X) distributions (log1p applied inside per ``log_norm``): the
    model's latents, without a module's nuisance posteriors (TotalVI's
    q(log β))."""
    out = self.apply(x, library=library, training=training,
                     sample_shape=sample_shape)
    return _one_or_tuple(out.latents[:self.n_latents])

  def decode(self, z, library=None, training: bool = False):
    """p(X|Z) distributions from latent samples or means. SCVI needs both
    latents (z, library), as ``encode`` returns them. No latent noise is
    drawn, as the JAX package's ``decode`` applies the module without a
    'sample' stream: TotalVI decodes log β at its posterior mean (the
    generator only feeds dropout masks in train mode). A batch-conditioned
    model decodes at the uniform batch prior."""
    zs = [_as_device_matrix(zi, self.device) for zi in _flatten(z)]
    self.module.train(training)
    with self._batch_stats_kept(training):
      if self.uses_library:
        if len(zs) < 2:
          raise ValueError(
              f"{type(self).__name__}.decode needs BOTH latent samples "
              "(z, library): pass encode()'s full tuple output, or use "
              "get_normalized_expression for the library-free scale")
        pX = self.module.decode(tuple(zs), generator=self.generator)
      else:
        zcat = self.module.reduce_latents(zs) if len(zs) > 1 else zs[0]
        pX = self.module.decode(zcat, generator=self.generator)
    return _one_or_tuple(pX)

  # -------------------------------------------------------------------- fit
  def _device_data(self, data) -> Tuple[List[torch.Tensor],
                                        Optional[torch.Tensor]]:
    """One matrix or a list of them, one per output, as float32 on the
    device, and the (n, 2) library stats of the first when the model uses
    them (numpy on the host for arrays, as the JAX package computes them;
    on the device for tensors)."""
    mats, library = self._sources(data)
    if len(mats) < len(self.outputs):
      raise ValueError(f"{len(mats)} data matrices for {len(self.outputs)} "
                       "outputs: give one per output, [rna, adt, …]")
    if library is not None:
      library = _as_device_matrix(library, self.device)
    return [_as_device_matrix(m, self.device) for m in mats], library

  def _sources(self, data) -> Tuple[List, Optional[object]]:
    """The matrices of ``data`` as given, and the (n, 2) library stats of
    the first when the model uses them."""
    mats = list(_flatten(data))
    if len({int(m.shape[0]) for m in mats}) != 1:
      raise ValueError("data matrices differ in their number of rows: "
                       f"{[tuple(m.shape) for m in mats]}")
    library = None
    if self.uses_library:
      mean, var = get_library_size(mats[0])
      cat = torch.cat if isinstance(mean, torch.Tensor) else np.concatenate
      library = cat([mean, var], 1)
    return mats, library

  def _evaluate(self, xs: Sequence[torch.Tensor],
                library: Optional[torch.Tensor],
                batch_size: int) -> Dict[str, float]:
    """Average metrics over device-resident data in sequential batches (the
    last one ragged), eval mode, mask = 1. Metrics stay on the device until
    one fetch at the end."""
    n = int(xs[0].shape[0])
    acc, keys = None, None
    for s in range(0, n, batch_size):
      b = min(batch_size, n - s)
      batch = {"inputs": [x[s:s + b] for x in xs],
               "mask": torch.ones((b,), device=self.device)}
      if library is not None:
        batch["library"] = library[s:s + b]
      metrics = self._eval_step(batch)
      if keys is None:
        keys = sorted(metrics)
      vec = torch.stack([metrics[k].float() for k in keys]) * b
      acc = vec if acc is None else acc + vec
    return {k: float(v) / n for k, v in zip(keys, acc.cpu().numpy())}

  def _trainable(self, freeze: Tuple[str, ...]) -> List[nn.Parameter]:
    """The parameters ``freeze`` leaves trainable: a parameter is frozen
    when a component of its flax path (``convert.flax_param_path``) starts
    with one of the prefixes, as the JAX ``fit`` builds its optax mask."""
    named = list(self.module.named_parameters())
    if not freeze:
      return [p for _, p in named]
    keep = [p for k, p in named
            if not any(c.startswith(f) for f in freeze
                       for c in convert.flax_param_path(self.module, k))]
    if len(keep) == len(named):
      raise ValueError(f"freeze={freeze} matched no parameters")
    return keep

  def _fit_optimizer(self, trainer: Trainer, freeze: Tuple[str, ...]):
    """This call's optimizer over the trainable parameters. As the JAX
    ``fit``, the transform is built from the call's arguments each time
    while the state carries over; it starts afresh when the freeze set
    (its structure) or the optimizer changes."""
    opt = trainer.make_optimizer(self._trainable(freeze))
    old = self.optimizer
    if (old is not None and freeze == self._last_freeze
        and getattr(old, "name", None) == opt.name):
      opt.carry_state(old)
    self.optimizer = opt
    self._last_freeze = freeze

  def _to_feeder(self, data, batch_size: int, labels_percent: float,
                 shuffle: bool = True) -> DataFeeder:
    """One matrix or a list of them (numpy, scipy sparse or tensor), or a
    ``DataFeeder`` as it is → ``DataFeeder`` (the JAX ``_to_feeder``; the
    port takes no ``SingleCellOMIC``). With batch conditioning the LAST
    matrix must be the batch one-hot. The library stats are the first
    matrix's, when the model uses them."""
    if isinstance(data, DataFeeder):
      return data
    mats, library = self._sources(data)
    if isinstance(library, torch.Tensor):
      library = library.cpu().numpy()
    return DataFeeder(mats, library=library, labels_percent=labels_percent,
                      batch_size=batch_size, shuffle=shuffle)

  def fit(self,
          train,
          valid=None,
          epochs: int = 100,
          batch_size: int = 64,
          learning_rate: float = 1e-3,
          optimizer: str = "adam",
          clipnorm: float = 100.0,
          labels_percent: float = 0.8,
          valid_freq: int = 500,
          patience: int = 20,
          min_delta: float = 1e-4,
          track_gradient_norms: bool = False,
          terminate_on_nan: bool = True,
          allow_rollback: bool = True,
          max_iter: Optional[int] = None,
          callbacks: Sequence[TrainingCallback] = (),
          checkpoint_path: Optional[str] = None,
          scan_steps: int = 1,
          device_cache: bool = False,
          device_dtype: str = "float32",
          transfer_dtype: Optional[str] = None,
          metrics_interval: int = 1,
          mesh=None,
          hbm_budget_bytes: Optional[int] = None,
          profile_dir: Optional[str] = None,
          mc_samples: int = 1,
          freeze: Sequence[str] = (),
          verbose: bool = False) -> "SingleCellModel":
    """Train on ``train`` and validate on ``valid`` (each one matrix or a
    list ``[rna, adt, …]``, numpy, scipy sparse or tensor, or a
    ``DataFeeder``), with the JAX ``fit``'s arguments and loops
    (``train/trainer.py``):

    * ``device_cache=False`` (the default) streams: every step's batch is
      gathered on the host and uploaded (``transfer_dtype='int16'`` or
      'auto' halves the upload of integral counts); validation every
      ``valid_freq`` steps, else at each epoch's end.
    * ``device_cache=True`` keeps the data on the device when its dense
      bytes fit the budget (half of the card's memory, or
      ``hbm_budget_bytes``): one fetch and one validation per window of
      ``metrics_interval`` epochs. Larger data trains out of core: equal
      random chunks, as many resident as fit, the rest uploaded each
      epoch while the previous one trains, a CSR source as triplets.
      ``device_dtype``: 'float32', 'int16' (exact) or 'bfloat16' (lossy)
      for the data kept on the device.
    Early stopping monitors ``val_loss`` (else ``loss``) with ``min_delta``
    and ``patience`` epochs.

    ``optimizer``: 'adam', 'adamw', 'sgd', 'rmsprop', 'adamax',
    'adafactor' or 'lion' (``train/optim.py``), after
    ``clip_by_global_norm(clipnorm)``. ``mc_samples``: S reparameterized
    draws per cell in training. ``track_gradient_norms``: ``grad_norm``
    in the history (the pre-clip global norm over every parameter).
    ``freeze=('decoder', 'output_head_rna', …)``: parameters with a flax
    path component starting with one of these get no update; their
    gradients are still computed and BatchNorm statistics still move.
    ``callbacks``: ``TrainingCallback``s. ``checkpoint_path``: the weights
    (``train/checkpoint.save_weights``, no metamodel) are written there at
    each new best. ``profile_dir``: a ``torch.profiler`` chrome trace of
    the fit, ``trace.json``.

    ``scan_steps=k``: the streaming loop uploads k batches as one chunk
    and runs their k steps from it (``Trainer``).

    ``mesh``: a ``parallel.create_mesh(n_data, n_model)`` of the calling
    world, every rank making this call with the same data and seed. Each
    step is the single-device step on the same global batch (each data
    rank takes its rows; the draws, BatchNorm statistics and means are
    the global batch's; the gradients are summed over 'data'); leaves the
    model axis splits are held and optimized as slices and gathered for
    each forward. The whole model, its optimizer state and the history
    are on every rank when it returns; ``checkpoint_path`` is written by
    rank 0."""
    view = None if mesh is None else PF.MeshView(mesh)
    if not self.is_semi_supervised:
      labels_percent = 0.0
    train_feeder = self._to_feeder(train, batch_size, labels_percent)
    if train_feeder.n_inputs < len(self.outputs):
      raise ValueError(f"{train_feeder.n_inputs} data matrices for "
                       f"{len(self.outputs)} outputs: give one per output, "
                       "[rna, adt, …]")
    valid_feeder = (self._to_feeder(valid, batch_size, 1.0, shuffle=False)
                    if valid is not None else None)
    if transfer_dtype and not device_cache:
      train_feeder.set_transfer_dtype(transfer_dtype)
      if valid_feeder is not None:
        valid_feeder.set_transfer_dtype(transfer_dtype)
    trainer = Trainer(optimizer=optimizer, learning_rate=learning_rate,
                      clipnorm=clipnorm, valid_freq=valid_freq,
                      patience=patience, min_delta=min_delta,
                      terminate_on_nan=terminate_on_nan,
                      allow_rollback=allow_rollback, max_iter=max_iter,
                      device_cache=device_cache, device_dtype=device_dtype,
                      metrics_interval=metrics_interval,
                      hbm_budget_bytes=hbm_budget_bytes, device=self.device,
                      scan_steps=scan_steps, mesh=mesh, verbose=verbose)
    freeze = (freeze,) if isinstance(freeze, str) else tuple(freeze)
    self._fit_optimizer(trainer, freeze)
    split = (PF.ModelSplit(self.module, view, self.optimizer)
             if view is not None and view.n_model > 1 else None)
    if self.aux is not None and self.aux_optimizer is None:
      self.aux_optimizer = self._make_aux_optimizer()
    self._train_mc_samples = max(1, int(mc_samples))
    self._track_grad_norms = bool(track_gradient_norms)
    ckpt_fn = None
    if checkpoint_path is not None:
      ckpt_fn = lambda m: m._save_checkpoint_weights(  # noqa: E731
          checkpoint_path)
    trace = (self._profile(profile_dir) if profile_dir is not None
             else contextlib.nullcontext())
    self._split = split
    self.optimizer.split_ids = None if split is None else split.ids
    try:
      with trace, PF.active(view):
        trainer.fit(self, train_feeder, valid_feeder, epochs=epochs,
                    callbacks=tuple(callbacks), checkpoint_fn=ckpt_fn)
        if split is not None:  # every rank's slices → the whole model
          split.close()
    finally:
      self._split = None
      self.optimizer.split_ids = None
    # one history across successive fit calls
    if self.trainer is None:
      self.trainer = trainer
    else:
      for k, v in trainer.history.items():
        self.trainer.history.setdefault(k, []).extend(v)
    return self

  def fit_query(self, query, train_keys: Sequence[str] = ("encoder",
                                                          "latent_head"),
                **fit_kwargs) -> "SingleCellModel":
    """scArches-style reference mapping (the JAX package's ``fit_query``):
    adapt the inference network to ``query`` while the generative model
    stays frozen. Every top-level parameter group whose flax name does not
    start with one of ``train_keys`` is frozen. Accepts every ``fit``
    argument."""
    train_keys = tuple(train_keys)
    params, _ = convert.torch_to_jax(self.module, values=())
    frozen = tuple(sorted(str(k) for k in params
                          if not str(k).startswith(train_keys)))
    if not frozen or len(frozen) == len(params):
      raise ValueError(f"train_keys={train_keys} must split the parameter "
                       f"tree; top-level keys: {sorted(params)}")
    return self.fit(query, freeze=frozen, **fit_kwargs)

  def _save_checkpoint_weights(self, path: str,
                               backend: str = "msgpack") -> None:
    """The current weights in the JAX layout (``params.msgpack``, +
    ``batch_stats.msgpack``, + ``aux_params.msgpack``), without the
    metamodel: what the JAX ``fit`` writes to ``checkpoint_path``. In a
    world every rank calls it: the full leaves are gathered and rank 0
    writes (``ckpt.on_main_rank``)."""
    state = None if self._split is None else self._split.full_state()
    params, batch_stats = convert.torch_to_jax(self.module, state=state)
    aux = None if self.aux is None else convert.torch_to_jax(self.aux)[0]
    ckpt.on_main_rank(lambda: ckpt.save_weights(
        path, params, batch_stats or None, aux_params=aux, backend=backend))

  @contextlib.contextmanager
  def _profile(self, profile_dir: str):
    """A ``torch.profiler`` trace of the block (the card's kernels too on
    CUDA), written to ``profile_dir/trace.json``: the counterpart of the
    JAX package's ``profile_trace``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if self.device.type == "cuda":
      acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
      yield prof
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))

  # ---------------------------------------------------------------- evaluate
  def evaluate(self, data, batch_size: int = 256) -> Dict[str, float]:
    """Average loss/LLK/KL metrics over ``data`` (one matrix or a list, as
    in ``fit``), eval mode, mask = 1 as in validation."""
    xs, lib = self._device_data(data)
    return self._evaluate(xs, lib, batch_size)

  # ------------------------------------------------------- serving batches
  def _serving_inputs(self, inputs):
    """(encoder matrices, library stats) of a serving call: only the
    sources ``_module_input`` consumes are kept."""
    mats, library = self._sources(inputs)
    return [mats[i] for i in self._serving_source_indices(len(mats))], \
        library

  def _serve(self, x: torch.Tensor, library: Optional[torch.Tensor],
             sample_shape: Tuple[int, ...],
             rows: Optional[int] = None) -> VAEOutput:
    """Eval-mode forward of one device batch (callers hold ``no_grad``).
    ``rows``: the global batch's rows on a mesh, of which ``x`` is this
    rank's part (its draws are the global batch's)."""
    self.module.eval()
    ctx = (contextlib.nullcontext() if rows is None
           else PF.batch_rows(rows, *PF.local_rows(rows)))
    with ctx:
      return self.module(x.to(torch.float32),
                         library=library if self.uses_library else None,
                         sample_shape=sample_shape, generator=self.generator)

  @staticmethod
  def _serving_batch(batch_size: int) -> int:
    """The global serving batch: on a data mesh rounded up to a multiple
    of n_data (at least two rows a rank, so a per-gene row is told from a
    cell's)."""
    view = PF.current()
    if view is None or view.n_data == 1:
      return int(batch_size)
    nd = view.n_data
    return max(2 * nd, -(-int(batch_size) // nd) * nd)

  def _serving_budget(self) -> Optional[int]:
    """Bytes a serving call may upload at once: 0.35 of the card's memory,
    ``SISUA_TPU_SERVING_BUDGET`` when set; on the CPU only the variable
    sets one (else nothing is chunked)."""
    env = os.environ.get("SISUA_TPU_SERVING_BUDGET")
    if env:
      return int(env)
    if self.device.type == "cuda":
      return int(SERVING_BUDGET_FRACTION * device_memory_limit(
          device=self.device))
    return None

  def _serving_chunks(self, mats, batch_size: int,
                      extra_bytes_per_row: int = 0
                      ) -> Optional[List[np.ndarray]]:
    """Row chunks for out-of-core serving: None when the dense upload fits
    the budget, else equal-size row-index arrays (the last padded by
    wrapping; consumers trim with each chunk's real count).
    ``extra_bytes_per_row`` budgets side uploads (``compute_llk``'s
    targets)."""
    n, B = int(mats[0].shape[0]), int(batch_size)
    bytes_per_row = 4 * sum(int(m.shape[1]) for m in mats) \
        + int(extra_bytes_per_row)
    budget = self._serving_budget()
    view = PF.current()
    if (budget is not None and view is not None
        and not os.environ.get("SISUA_TPU_SERVING_BUDGET")):
      budget *= view.n_data  # each data rank holds its share of a chunk
    if budget is None or n * bytes_per_row <= budget:
      return None
    rows_per = max(B, (budget // 2 // bytes_per_row) // B * B)
    if rows_per >= n:
      return None  # cannot chunk below one batch: a single upload
    idx = np.arange(n, dtype=np.int64)
    return [np.resize(idx[lo:lo + rows_per], rows_per)
            for lo in range(0, n, rows_per)]

  def _iter_serving_chunks(self, mats, batch_size: int,
                           extra_bytes_per_row: int = 0):
    """Yield (rows, n_valid) per chunk; one (None, None) when everything
    fits."""
    chunks = self._serving_chunks(mats, batch_size, extra_bytes_per_row)
    if chunks is None:
      yield None, None
      return
    rows_per, n = len(chunks[0]), int(mats[0].shape[0])
    for ci, rows in enumerate(chunks):
      yield rows, min(rows_per, n - ci * rows_per)

  def _pad_to_batches(self, mat, k: int, B: int, n: int,
                      dtype: torch.dtype = torch.float32,
                      rows: Optional[np.ndarray] = None) -> torch.Tensor:
    """An (n, d) matrix (numpy, scipy sparse or tensor) as zero-padded
    (k, B, d) device batches; ``rows`` restricts to a chunk's rows (``n``
    is then its real count). A tensor is gathered where it lies and cast
    before it moves, so an int16 upload crosses the link as int16."""
    d = int(mat.shape[1])
    if isinstance(mat, torch.Tensor):
      src = mat if rows is None else mat.index_select(
          0, torch.as_tensor(rows[:n], device=mat.device))
      src = src[:n].to(dtype=dtype)
      if n == k * B and src.device == self.device:
        return src.reshape(k, B, d)
      buf = torch.zeros((k * B, d), dtype=dtype, device=self.device)
      buf[:n] = src.to(self.device)
      return buf.view(k, B, d)
    if rows is not None:
      mat = mat[np.ascontiguousarray(rows[:n], np.int64)]
    a = mat.toarray() if hasattr(mat, "toarray") else np.asarray(mat)
    buf = np.zeros((k * B, d), _NUMPY_DTYPES[dtype])
    buf[:n] = a[:n]
    return torch.from_numpy(buf).to(self.device).view(k, B, d)

  def _sparse_or_dense_batches(self, mat, k: int, B: int, n: int,
                               dtype: torch.dtype = torch.float32,
                               rows: Optional[np.ndarray] = None
                               ) -> torch.Tensor:
    """(k, B, d) device batches of one serving matrix. A scipy sparse
    matrix whose triplets are clearly smaller than the dense block
    uploads them, (vals, cols, rowlen), and is densified on the device
    (``ops/sparse.py``); everything else takes ``_pad_to_batches``. The
    padded nonzero count is bucketed (≤ 12.5% slack), as in the JAX
    package. ``rows`` restricts to a serving chunk."""
    if not sparse.issparse(mat):
      return self._pad_to_batches(mat, k, B, n, dtype, rows)
    csr = mat.tocsr()
    indptr, d = csr.indptr, int(mat.shape[1])
    itemsize = torch.empty((), dtype=dtype).element_size()
    take = None if rows is None else np.ascontiguousarray(rows[:n], np.int64)
    nnz = (int(indptr[-1]) if take is None
           else int((indptr[take + 1] - indptr[take]).sum()))
    if not worthwhile(nnz, k * B, d, itemsize, itemsize):
      return self._pad_to_batches(mat, k, B, n, dtype, rows)
    step = max(8, 1 << (max(nnz.bit_length(), 4) - 4))
    cap = -(-max(8, nnz) // step) * step
    vals, cols, rowlen = csr_row_triplets(
        indptr, csr.indices, csr.data, rows=take, cap=cap, n_rows=k * B,
        val_dtype=_NUMPY_DTYPES[dtype], col_dtype=col_dtype_for(d))
    if cols.dtype == np.uint16:
      cols = cols.view(np.int16)  # see ops/sparse.column_ids
    return densify(torch.from_numpy(vals), torch.from_numpy(cols),
                   torch.from_numpy(rowlen), d, dtype,
                   self.device).view(k, B, d)

  def _upload_dtype(self, mats, input_dtype: Optional[str]) -> torch.dtype:
    """int16 for ``input_dtype='auto'`` when every value of every encoder
    matrix is an integer below 32,767 in magnitude (exact, half the bytes
    of the upload; widened on the device), else float32; 'int16' demands
    it. A tensor already on the serving device has nothing to upload and
    stays float32."""
    if input_dtype not in ("auto", "int16"):
      return torch.float32
    if any(isinstance(m, torch.Tensor) and m.device == self.device
           for m in mats):
      return torch.float32
    values = (m.data if hasattr(m, "toarray") else
              m.cpu() if isinstance(m, torch.Tensor) else m for m in mats)
    if all(int16_exact(v) for v in values):
      return torch.int16
    if input_dtype == "int16":
      raise ValueError("input_dtype='int16' requires integral counts "
                       "< 32767 in every consumed source")
    return torch.float32

  def _device_batches(self, mats, library, batch_size: int,
                      dtype: torch.dtype = torch.float32,
                      rows: Optional[np.ndarray] = None,
                      n_valid: Optional[int] = None):
    """The encoder matrix (and library stats) as full (k, B, d) device
    batches: ``(xb, lib_b, k, B, n)``, the last batch zero-padded, so every
    chunk shares one shape; trim to ``n`` rows after the fetch."""
    n = int(mats[0].shape[0]) if n_valid is None else int(n_valid)
    B = int(batch_size)
    k = -(-n // B) if rows is None else len(rows) // B
    xs = [self._sparse_or_dense_batches(m, k, B, n, dtype, rows)
          for m in mats]
    xb = self._module_input([x.reshape(k * B, -1) for x in xs])
    lib_b = (self._pad_to_batches(library, k, B, n, rows=rows)
             if library is not None else None)
    return xb.reshape(k, B, -1), lib_b, k, B, n

  @staticmethod
  def _mesh_take(k: int, B: int, n: int, rows: Optional[np.ndarray]
                 ) -> Optional[np.ndarray]:
    """On a data mesh, the source rows of this rank's part [lo, hi) of
    each of k batches of B (a chunk's ``rows``, or the first n): a
    padding position wraps onto a real row, whose output is dropped after
    the gather. None without a mesh."""
    view = PF.current()
    if view is None or view.n_data == 1:
      return None
    lo, hi = view.rows(B)
    pos = (np.arange(k)[:, None] * B + np.arange(lo, hi)[None, :]).ravel()
    base = np.arange(n, dtype=np.int64) if rows is None else \
        np.asarray(rows[:n], np.int64)
    return base[pos % n]

  def _chunk_batches(self, mats, library, batch_size: int,
                     input_dtype: Optional[str] = None,
                     extra_bytes_per_row: int = 0) -> Iterator:
    """Per serving chunk: ``(xb, lib_b, k, B, n, rows)`` (B the global
    batch: ``_serving_batch``). On a data mesh ``xb`` is (k, b, d), this
    rank's rows of each batch (``_mesh_take``)."""
    dtype = self._upload_dtype(mats, input_dtype)
    B = self._serving_batch(batch_size)
    for rows, nv in self._iter_serving_chunks(mats, B,
                                              extra_bytes_per_row):
      n = int(mats[0].shape[0]) if nv is None else nv
      k = -(-n // B) if rows is None else len(rows) // B
      take = self._mesh_take(k, B, n, rows)
      if take is None:
        yield self._device_batches(mats, library, B, dtype, rows,
                                   nv) + (rows,)
      else:
        xb, lib_b = self._device_batches(mats, library, len(take) // k,
                                         dtype, take, len(take))[:2]
        yield xb, lib_b, k, B, n, rows

  # ----------------------------------------------------------------- predict
  def predict(self,
              inputs,
              sample_shape: Tuple[int, ...] = (),
              batch_size: int = 256,
              device_cache: bool = False,
              mesh=None,
              verbose: bool = False):
    """Minibatch inference → (pX, qZ), each merged across batches, with
    every tensor on the CPU. Output leaves concatenate on the axis after
    the MC sample dims, latents on axis 0; batch-invariant (1, D) rows stay
    one row (``_merge_batch_leaves``). Priors are not returned.

    Streaming fetches each batch's distributions to the host;
    ``device_cache=True`` uploads each serving chunk once, runs its padded
    batches on the device and fetches the chunk's merged result once.
    ``mesh``: either path over the mesh's data axis (module docstring):
    each rank serves its rows of every batch, with the draws of the
    single-device call."""
    mats, library = self._serving_inputs(inputs)
    sample_shape = _as_shape(sample_shape)
    if device_cache:
      with PF.active(mesh):
        return self._predict_device_cached(mats, library, batch_size,
                                           sample_shape)
    n, ax = int(mats[0].shape[0]), len(sample_shape)
    outs, lats = [], []
    with torch.no_grad(), PF.active(mesh):
      view = PF.current()
      n_data = 1 if view is None else view.n_data
      for s in range(0, n, batch_size):
        # on a mesh this rank's rows of the batch (all of a batch too
        # short for two rows a rank: a per-gene row must stay told from a
        # cell's), every rank's gathered after the forward
        b = min(batch_size, n - s)
        split = n_data > 1 and b >= 2 * n_data
        lo, hi = PF.local_rows(b) if split else (0, b)
        x = self._module_input([_as_device_matrix(m[s + lo:s + hi],
                                                  self.device) for m in mats])
        lib = (None if library is None else
               _as_device_matrix(library[s + lo:s + hi], self.device))
        with (PF.batch_rows(b, lo, hi) if split
              else contextlib.nullcontext()):
          out = self._serve(x, lib, sample_shape)
          pX = _gathered_rows(out.outputs, ax, hi - lo)
          qZ = _gathered_rows(out.latents[:self.n_latents], 0, hi - lo)
        outs.append(_to_host(pX))
        lats.append(_to_host(qZ))
      pX = _merge_dists(outs, ax)
      qZ = _merge_dists(lats, 0)
    return _one_or_tuple(pX), _one_or_tuple(qZ)

  def _predict_device_cached(self, mats, library, batch_size: int,
                             sample_shape: Tuple[int, ...]):
    ax = len(sample_shape)
    parts = []
    with torch.no_grad():
      for xb, lib_b, k, B, n, _ in self._chunk_batches(mats, library,
                                                       batch_size):
        outs = [self._serve(xb[i], None if lib_b is None else lib_b[i],
                            sample_shape, rows=B) for i in range(k)]
        if PF.current() is None:
          keep = dict(n=n, batch=B)
          px = _merge_dists([o.outputs for o in outs], ax, **keep)
          qz = _merge_dists([o.latents[:self.n_latents] for o in outs], 0,
                            **keep)
        else:  # this rank's rows of every batch, then everyone's
          b = int(xb.shape[1])
          px = _gathered_dists(_merge_dists(
              [o.outputs for o in outs], ax, batch=b), ax, k, b, n)
          qz = _gathered_dists(_merge_dists(
              [o.latents[:self.n_latents] for o in outs], 0, batch=b), 0,
              k, b, n)
        parts.append((_to_host(px), _to_host(qz)))
        del outs
      if len(parts) == 1:
        pX, qZ = parts[0]
      else:
        pX = _merge_dists([p[0] for p in parts], ax)
        qZ = _merge_dists([p[1] for p in parts], 0)
    return _one_or_tuple(pX), _one_or_tuple(qZ)

  def predict_mean(self, inputs, sample_shape: Tuple[int, ...] = (),
                   batch_size: int = 256,
                   input_dtype: Optional[str] = "auto",
                   fetch_dtype: str = "float32",
                   mesh=None):
    """Posterior means only, computed on the device and fetched as (n, d)
    float32 numpy arrays: ``(output_means, latent_means)``, MC sample dims
    averaged on the device. ``input_dtype='auto'`` uploads integral counts
    as int16; ``fetch_dtype='bfloat16'`` halves the fetched bytes at ~0.4%
    relative error. ``mesh``: over the mesh's data axis (module
    docstring)."""
    mats, library = self._serving_inputs(inputs)
    sample_shape = _as_shape(sample_shape)
    mc_axes = tuple(range(len(sample_shape)))
    out_dt = {"float32": torch.float32,
              "bfloat16": torch.bfloat16}[str(fetch_dtype)]
    parts_x, parts_z = [], []
    with torch.no_grad(), PF.active(mesh):
      for xb, lib_b, k, B, n, _ in self._chunk_batches(
          mats, library, batch_size, input_dtype=input_dtype):
        xm, zm = [], []
        for i in range(k):
          out = self._serve(xb[i], None if lib_b is None else lib_b[i],
                            sample_shape, rows=B)
          xm.append([(p.mean().mean(dim=mc_axes) if mc_axes
                      else p.mean()).to(out_dt) for p in out.outputs])
          zm.append([q.mean().to(out_dt)
                     for q in out.latents[:self.n_latents]])

        def fetch(per_batch):
          return [PF.gather_batches(torch.cat(leaves), k)[:n].cpu()
                  .float().numpy() for leaves in zip(*per_batch)]
        parts_x.append(fetch(xm))
        parts_z.append(fetch(zm))
        del xm, zm
    if len(parts_x) == 1:
      return parts_x[0], parts_z[0]
    cat = lambda parts: [np.concatenate([p[i] for p in parts], axis=0)
                         for i in range(len(parts[0]))]
    return cat(parts_x), cat(parts_z)

  def _served_batches(self, inputs, sample_shape: Tuple[int, ...] = (),
                      batch_size: int = 256) -> Iterator:
    """Eval-mode forwards of every serving batch, on the device, in row
    order: ``(out, lo, n_valid)``, the batch's first row and its rows
    that are data (the rest is padding). Callers hold ``no_grad``. On one
    device, also inside a mesh fit (a callback's)."""
    mats, library = self._serving_inputs(inputs)
    sample_shape = _as_shape(sample_shape)
    with PF.active(None):
      for xb, lib_b, k, B, n, rows in self._chunk_batches(mats, library,
                                                          batch_size):
        start = 0 if rows is None else int(rows[0])
        for i in range(k):
          out = self._serve(xb[i], None if lib_b is None else lib_b[i],
                            sample_shape)
          yield out, start + i * B, min(B, n - i * B)

  def _normalized_draws(self, inputs, sample_shape: Tuple[int, ...],
                        batch_size: int, output_index: int,
                        reduce_mc: bool) -> Iterator[torch.Tensor]:
    """``get_normalized_expression`` per serving batch, left on the
    device: (b, d), or (S, b, d) with ``reduce_mc=False``; on the active
    mesh per serving chunk, every rank's rows gathered. Callers hold
    ``no_grad``."""
    sample_shape = _as_shape(sample_shape)
    mc_axes = tuple(range(len(sample_shape)))
    reduce_mc = bool(reduce_mc) or not mc_axes
    S = math.prod(sample_shape)

    def scales(out):
      m = out.outputs[int(output_index)].mean()
      scale = m / torch.sum(m, dim=-1, keepdim=True)
      if reduce_mc:
        return scale.mean(dim=mc_axes) if mc_axes else scale
      return scale.reshape((S,) + scale.shape[len(mc_axes):])  # (S, B, d)
    ax = 0 if reduce_mc else 1
    if PF.current() is None:
      for out, _, nv in self._served_batches(inputs, sample_shape,
                                             batch_size):
        yield scales(out).narrow(ax, 0, nv)
      return
    mats, library = self._serving_inputs(inputs)
    for xb, lib_b, k, B, n, _ in self._chunk_batches(mats, library,
                                                     batch_size):
      mine = torch.cat([scales(self._serve(
          xb[i], None if lib_b is None else lib_b[i], sample_shape,
          rows=B)) for i in range(k)], ax)
      yield PF.gather_batches(mine, k, ax).narrow(ax, 0, n)

  def get_normalized_expression(self, inputs,
                                sample_shape: Tuple[int, ...] = (),
                                batch_size: int = 256,
                                output_index: int = 0,
                                reduce_mc: bool = True,
                                mesh=None) -> np.ndarray:
    """Library-size-free denoised expression: each posterior draw's output
    mean as row proportions, MC-averaged on the device → (n, d). For SCVI
    this is ``px_scale``. ``reduce_mc=False`` returns the per-draw scales
    (S, n, d), S = prod(sample_shape). ``mesh``: over the mesh's data axis
    (module docstring)."""
    axis = 0 if reduce_mc or not _as_shape(sample_shape) else 1
    with torch.no_grad(), PF.active(mesh):
      return np.concatenate(
          [t.cpu().numpy() for t in self._normalized_draws(
              inputs, sample_shape, batch_size, output_index, reduce_mc)],
          axis)

  def differential_expression(self, inputs, labels, group1=None,
                              group2=None, mode: str = "change",
                              delta: float = 0.25,
                              sample_shape: Tuple[int, ...] = (25,),
                              n_pairs: int = 5000, max_cells: int = 256,
                              batch_size: int = 256, output_index: int = 0,
                              seed: int = 0,
                              var_names: Optional[Sequence[str]] = None,
                              mesh=None) -> Dict[str, np.ndarray]:
    """Bayesian differential expression between cell groups (the JAX
    package's ``differential_expression``; scvi-tools' surface).

    Posterior scales are drawn per cell (``get_normalized_expression``
    with ``reduce_mc=False``, left on the device), then ``n_pairs`` random
    cross-group draw pairs estimate, per gene:

      * ``mode='vanilla'``: ``proba_m1 = P(s1 > s2)`` and its Bayes factor
        ``log(p + eps) − log1p(eps − p)``;
      * ``mode='change'`` (default): ``lfc = log2(s1) − log2(s2)`` with
        ``proba_de = P(|lfc| > delta)``, its Bayes factor, and the lfc's
        mean, median and std (ddof 0).

    ``labels``: one label per cell of ``inputs`` (compared as ``str``).
    ``group2=None`` compares against all other cells; ``group1=None`` runs
    one-vs-rest for every level in order of first appearance and stacks
    the results, with a ``group1`` column. ``max_cells`` caps each group's
    subsample. numpy's ``RandomState(seed)`` draws the subsamples (group
    1's, then group 2's) and then the pairs, as in the JAX package.
    Returns ``{column: array}`` in the JAX DataFrame's column order, with
    ``gene`` from ``var_names`` when given. The statistics are float64 on
    the device; on the CPU they are the JAX package's numpy statements.
    ``mesh``: the scales are drawn over the mesh's data axis, and every
    rank computes the same statistics from them."""
    labels = np.asarray([str(v) for v in np.asarray(labels)])
    n = int(_flatten(inputs)[0].shape[0])
    if len(labels) != n:
      raise ValueError(f"{len(labels)} labels for {n} cells")
    kw = dict(group2=group2, mode=mode, delta=delta,
              sample_shape=sample_shape, n_pairs=n_pairs,
              max_cells=max_cells, batch_size=batch_size,
              output_index=output_index, seed=seed, var_names=var_names,
              mesh=mesh)
    if group1 is None:
      levels = list(dict.fromkeys(labels))  # first appearance (pd.unique)
      parts = [self.differential_expression(inputs, labels, group1=lvl,
                                            **kw) for lvl in levels]
      out = {"group1": np.concatenate([np.full(len(p["scale1"]), lvl)
                                       for lvl, p in zip(levels, parts)])}
      out.update({k: np.concatenate([p[k] for p in parts])
                  for k in parts[0]})
      return out
    rng = np.random.RandomState(seed)
    m1 = labels == str(group1)
    m2 = (labels == str(group2)) if group2 is not None else ~m1
    if not m1.any() or not m2.any():
      raise ValueError(f"empty group: |{group1}|={int(m1.sum())}, "
                       f"|{group2 or 'rest'}|={int(m2.sum())}")
    if mode not in ("vanilla", "change"):
      raise ValueError(f"mode must be 'vanilla' or 'change', got {mode!r}")

    def scales(mask):
      idx = np.flatnonzero(mask)
      if len(idx) > int(max_cells):
        idx = rng.choice(idx, int(max_cells), replace=False)
      with torch.no_grad(), PF.active(mesh):
        s = torch.cat(list(self._normalized_draws(
            _take_rows(inputs, np.sort(idx)), sample_shape, batch_size,
            output_index, reduce_mc=False)), 1)
      return s.to(torch.float64).reshape(-1, s.shape[-1])  # (S·m, d)

    s1, s2 = scales(m1), scales(m2)
    i1 = rng.randint(0, len(s1), int(n_pairs))
    i2 = rng.randint(0, len(s2), int(n_pairs))
    if s1.device.type == "cpu":
      out = _de_stats_numpy(s1.numpy(), s2.numpy(), i1, i2, mode, delta)
    else:
      out = _de_stats_torch(s1, s2, i1, i2, mode, delta)
    if var_names is not None:
      if len(var_names) != len(out["scale1"]):
        raise ValueError(f"{len(var_names)} var_names for "
                         f"{len(out['scale1'])} genes")
      out = {"gene": np.asarray(var_names, str), **out}
    return out

  def compute_llk(self, inputs, targets: Dict[str, Sequence],
                  sample_shape: Tuple[int, ...] = (),
                  batch_size: int = 256, mesh=None) -> Dict[str, float]:
    """Mean per-cell log-likelihood of each tagged target set under the
    posterior predictive, ``{f"{tag}_output{i}": mean_llk}``, summed on the
    device. ``targets``: tag → per-output (n, d_i) matrices. MC sample dims
    collapse as logsumexp − log S; padded rows are masked out. The targets
    count in the chunk budget. A ZINB/NB head's log-probs take the fused
    forward with the draws as its member axis
    (``objective.mc_row_log_prob``: one launch per head, target set and
    batch on the card); every other head the distribution math.
    ``mesh``: each rank sums its rows, and the sums are added over
    'data'."""
    mats, library = self._serving_inputs(inputs)
    sample_shape = _as_shape(sample_shape)
    log_s = math.log(float(math.prod(sample_shape)))
    tgt_bytes = 4 * sum(int(m.shape[1]) for ms in targets.values()
                        for m in ms)
    totals: Dict[str, float] = {}
    with torch.no_grad(), PF.active(mesh):
      for xb, lib_b, k, B, n, rows in self._chunk_batches(
          mats, library, batch_size, extra_bytes_per_row=tgt_bytes):
        take = self._mesh_take(k, B, n, rows)
        b = int(xb.shape[1])
        if take is None:
          tgt_b = {t: [self._pad_to_batches(m, k, B, n, rows=rows)
                       for m in ms] for t, ms in targets.items()}
          pos = torch.arange(k * B, device=self.device).view(k, B)
        else:  # this rank's rows of each batch, and their positions
          tgt_b = {t: [self._pad_to_batches(m, k, b, k * b, rows=take)
                       for m in ms] for t, ms in targets.items()}
          lo = PF.local_rows(B)[0]
          pos = (torch.arange(k, device=self.device)[:, None] * B + lo
                 + torch.arange(b, device=self.device)[None, :])
        mask = (pos < n).to(torch.float32)
        sums: Dict[str, torch.Tensor] = {}
        for i in range(k):
          out = self._serve(xb[i], None if lib_b is None else lib_b[i],
                            sample_shape, rows=B)
          for t, ms in tgt_b.items():
            for j, (pX, m) in enumerate(zip(out.outputs, ms)):
              lp = mc_row_log_prob(pX, m[i])               # (S…, B)
              if lp.ndim > 1:
                lp = torch.logsumexp(lp.reshape(-1, lp.shape[-1]), 0) \
                    - log_s
              key = f"{t}_output{j}"
              sums[key] = sums.get(key, 0.0) + torch.sum(lp * mask[i])
        for key, v in sums.items():
          totals[key] = totals.get(key, 0.0) + float(PF.data_sum(v))
    n_obs = int(mats[0].shape[0])
    return {key: v / n_obs for key, v in totals.items()}

  def marginal_log_prob(self, inputs, sample_shape: int = 100,
                        batch_size: int = 32, mesh=None) -> np.ndarray:
    """Importance-weighted marginal log-likelihood per cell,
    log p(x) ≈ logsumexp_s[log p(x|z_s) + log p(z_s) − log q(z_s|x)]
    − log S, over every latent of the forward (a nuisance one such as
    TotalVI's q(log β) included); a latent without a prior contributes
    zeros. The likelihood target is the first matrix. ``mesh``: each
    batch's rows split over 'data' (a batch of fewer rows than ranks: all
    of it on every rank), gathered in order."""
    mats, library = self._serving_inputs(inputs)
    S = int(sample_shape)
    n = int(mats[0].shape[0])
    chunks = []
    with torch.no_grad(), PF.active(mesh):
      view = PF.current()
      n_data = 1 if view is None else view.n_data
      for s in range(0, n, batch_size):
        b = min(batch_size, n - s)
        lo, hi = PF.local_rows(b) if b >= n_data else (0, b)
        xs = [_as_device_matrix(m[s + lo:s + hi], self.device)
              for m in mats]
        lib = (None if library is None else
               _as_device_matrix(library[s + lo:s + hi], self.device))
        with (PF.batch_rows(b, lo, hi) if b >= n_data
              else contextlib.nullcontext()):
          out = self._serve(self._module_input(xs), lib, (S,))
          llk = out.outputs[0].log_prob(xs[0])                 # (S, B)
          lq = sum(q.log_prob(z) for q, z in zip(out.latents,
                                                 out.latent_samples))
          lp = sum(prior.log_prob(z) if prior is not None
                   else torch.zeros(z.shape[:-1], device=z.device)
                   for prior, z in zip(out.priors, out.latent_samples))
          lw = llk + lp - lq
          mll = PF.gather_rows(torch.logsumexp(lw, 0) - math.log(S))
        chunks.append(mll.cpu().numpy())
    return np.concatenate(chunks, 0)

  # ---------------------------------------------------------------- analysis
  def create_posterior(self, test, var_names=None, dropout_rate: float = 0.2,
                       retain_rate: float = 0.2,
                       corruption_distribution: str = "binomial",
                       sample_shape: int = 10, batch_size: int = 256,
                       device_cache: bool = False, mesh=None,
                       verbose: bool = False):
    """The posterior analysis hub (``analysis.Posterior``) of this model on
    ``test``: ``{omic_name: (n, d) matrix}`` with ``var_names``
    ``{omic_name: names}``, in place of the JAX package's
    ``SingleCellOMIC``."""
    from ..analysis.posterior import Posterior
    return Posterior(self, test, var_names=var_names,
                     dropout_rate=dropout_rate, retain_rate=retain_rate,
                     corruption_distribution=corruption_distribution,
                     sample_shape=sample_shape, batch_size=batch_size,
                     device_cache=device_cache, mesh=mesh, verbose=verbose)

  # -------------------------------------------------------------------- io
  def save_weights(self, path: str, backend: str = "msgpack") -> str:
    """The JAX package's checkpoint: ``params.msgpack`` (+
    ``batch_stats.msgpack``, + ``aux_params.msgpack``) in the flax layout,
    ``metamodel.json``, and ``history.json`` when there is a history. The
    optimizer states and the step are not saved (nor are they by the JAX
    package). In a world every rank calls it and rank 0 writes."""
    self._save_checkpoint_weights(path, backend)

    def write_meta():
      ckpt.save_metamodel(path, type(self).__name__, self.dataset,
                          self.metadata, self._init_kwargs_for_save)
      hist = self.history
      if hist:
        with open(os.path.join(path, "history.json"), "w") as f:
          json.dump({k: [float(x) for x in v] for k, v in hist.items()}, f)
    ckpt.on_main_rank(write_meta)
    return path

  def load_weights(self, path: str, raise_notfound: bool = False
                   ) -> "SingleCellModel":
    """Read a checkpoint of either package into this model (every leaf
    checked against the module); ``self`` unchanged when there is none,
    unless ``raise_notfound``. ``history.json`` becomes ``history`` when
    the model has not been fitted."""
    if (not os.path.isfile(os.path.join(path, "params.msgpack"))
        and not os.path.isdir(os.path.join(path, "orbax"))):
      if raise_notfound:
        raise FileNotFoundError(f"No checkpoint at {path}")
      return self
    # the params file is always read: its template needs shapes only
    params_t, stats_t = convert.torch_to_jax(self.module,
                                             values=("batch_stats",))
    aux_t = None if self.aux is None else convert.torch_to_jax(self.aux)[0]
    params, stats, aux = ckpt.load_weights(path, params_t, stats_t or None,
                                           aux_t)
    self.module.load_state_dict(convert.jax_to_torch(self.module, params,
                                                     stats))
    if self.aux is not None:
      self.aux.load_state_dict(convert.jax_to_torch(self.aux, aux))
    hist_path = os.path.join(path, "history.json")
    if os.path.isfile(hist_path) and self.trainer is None:
      with open(hist_path) as f:
        self._loaded_history = json.load(f)
    return self

  save = save_weights

  def __repr__(self):
    return (f"{type(self).__name__}(id='{self.id}', outputs={self.outputs}, "
            f"latents={self.latents}, semi={self.is_semi_supervised})")
