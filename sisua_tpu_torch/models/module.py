"""Core VAE torch modules (port of ``sisua_tpu/models/module.py``).

    x ──encode──► q(Z|X) ──rsample──► decode ──► p(X|Z)

``forward`` returns a ``VAEOutput`` of distributions, latent samples and
priors; the ELBO is a function of it (``objective.py``). Train/eval mode is
the module's own (``module.train()``/``eval()``), as BatchNorm and dropout
read it. Randomness comes from an explicit ``torch.Generator`` (dropout
masks and reparameterization noise), or the noise is given directly
(``noise=``, one entry per latent) so a test can feed the JAX side's draws.
Each entry is what the latent's ``rsample`` takes as ``eps``: a standard-
normal tensor of the draw's shape for 'diag'/'normal'/'tril'; for a
mixture latent ('mixgaus'/'mdn'/'mixtril') the pair (component indices
(…, B), every component's standard noise (…, B, K, D)); None for a
deterministic latent (DCA). A module that draws again after the latents
(TotalVI's log β, SCANVI's z₂, AUTOZI's δ) takes that draw's noise as one
more entry, in the order the JAX module calls ``make_rng('sample')``.
A ``NoiseRecorder`` in place of the list learns those entries from one
forward (``VmapEnsemble``'s draw plan).

Batch-covariate conditioning (``n_batch`` > 0, scvi-tools semantics): the
module input may end in a batch one-hot block, which joins both the
encoder input and the decoder input; an input without it conditions on
the uniform batch prior 1/n_batch, so parameter shapes never change.

Submodule names are the flax names, so ``convert.py`` maps a JAX parameter
path to a ``state_dict`` key by joining with '.'.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import dist as D
from ..nn import DistributionDense, NetConf, dense, resolve_dtype
from ..rv import RVmeta

__all__ = ["VAEOutput", "VAEModule", "SCVIModule", "NoiseRecorder"]

# log 1e-7: floor of SCVI's log-space softmax (the linear path's clip)
_LOG_SCALE_FLOOR = -16.118095


def _gumbel(shape, generator) -> torch.Tensor:
  """Standard Gumbel noise, −log(−log U) with U floored at the smallest
  normal float (``jax.random.gumbel``)."""
  u = torch.rand(shape, generator=generator, device=generator.device)
  return -torch.log(-torch.log(torch.clamp_min(u, torch.finfo(u.dtype).tiny)))


class NoiseRecorder:
  """A forward's ``noise`` that records the draws instead of feeding
  them: each draw gets zeros of its shape in its place, and the recorder
  keeps a function that makes that draw for M members at once, (M, …),
  from a generator and the members' stacked parameters (keys as the
  module's ``named_parameters``). ``entries`` line up with the ``noise``
  list the forward reads; None marks a deterministic latent. Slicing
  gives the recorder itself, so a forward's later draws (log β, z₂, δ)
  record after its latents, in the order it reads them."""

  def __init__(self, device):
    self.device = torch.device(device)
    self.entries = []

  def __getitem__(self, index):
    if not isinstance(index, slice):
      raise TypeError("a NoiseRecorder is read by slices, as a forward "
                      "passes its later draws on")
    return self

  def record(self, draw, placeholder):
    """Keeps ``draw(m, generator, params)``; returns ``placeholder``."""
    self.entries.append(draw)
    return placeholder

  def latent(self, q: D.Distribution, sample_shape=()):
    """The ``eps`` of ``q.rsample``: standard noise, a mixture's pair
    (Gumbel noise (…, K) for ``jax.random.categorical``'s Gumbel-max, every
    component's noise), or None for a deterministic latent."""
    lead = tuple(sample_shape)
    zeros = lambda s: torch.zeros(s, device=self.device)  # noqa: E731
    if isinstance(q, D.VectorDeterministic):
      return self.record(None, None)
    if isinstance(q, D.MixtureSameFamily):
      ks = lead + tuple(q.batch_shape) + (q.n_components,)
      c = q.components
      cs = lead + tuple(c.batch_shape) + tuple(c.event_shape)
      return self.record(
          lambda m, gen, params: (
              _gumbel((m, *ks), gen),
              torch.randn((m, *cs), generator=gen, device=gen.device)),
          (zeros(ks), zeros(cs)))
    s = lead + tuple(q.batch_shape) + tuple(q.event_shape)
    return self.record(lambda m, gen, params: torch.randn(
        (m, *s), generator=gen, device=gen.device), zeros(s))


@dataclasses.dataclass
class VAEOutput:
  """Forward-pass result: everything the ELBO needs."""

  outputs: Tuple[D.Distribution, ...]        # p(X_i | Z)
  latents: Tuple[D.Distribution, ...]        # q(Z_j | X)
  latent_samples: Tuple[torch.Tensor, ...]   # reparameterized draws
  priors: Tuple[Optional[D.Distribution], ...]
  # terms a topology adds to its loss but not to serving (SCANVI's
  # per-class hierarchy penalty), read by the model's ``_extra_loss``
  aux_outputs: Tuple = ()


class VAEModule(nn.Module):
  """β-VAE engine over RVmeta/NetConf specs. Encoder i feeds latent head i
  (extra heads reuse the last encoder; a topology picks otherwise through
  ``_encoder_in_dim`` and ``_latent_head_source``); the first input is
  ``log1p``-ed when ``log_norm``."""

  def __init__(self, outputs: Sequence[RVmeta], latents: Sequence[RVmeta],
               encoder_confs: Sequence[NetConf],
               decoder_confs: Sequence[NetConf], log_norm: bool = True,
               reduce_latent: str = "concat", n_batch: int = 0,
               generator: Optional[torch.Generator] = None):
    super().__init__()
    self.outputs = tuple(outputs)
    self.latents = tuple(latents)
    self.log_norm = bool(log_norm)
    self.reduce_latent = reduce_latent
    self.n_batch = int(n_batch)
    self.encoders = []
    for i, c in enumerate(encoder_confs):
      self.add_module(f"encoder{i}", c.build(
          self._encoder_in_dim(i) + self.n_batch, generator))
      self.encoders.append(getattr(self, f"encoder{i}"))
    self.decoders = []
    for i, c in enumerate(decoder_confs):
      self.add_module(f"decoder{i}", c.build(
          self._decoder_in_dim() + self.n_batch, generator))
      self.decoders.append(getattr(self, f"decoder{i}"))
    self.latent_heads = []
    for i, rv in enumerate(self.latents):
      src = self._latent_head_source(i)
      if src is None:
        self.latent_heads.append(None)
        continue
      name = f"latent_head_{rv.name or i}"
      self.add_module(name, DistributionDense(self.encoders[src].out_dim, rv,
                                              generator))
      self.latent_heads.append(getattr(self, name))
    self.output_heads = []
    for i, rv in enumerate(self.outputs):
      name = f"output_head_{rv.name or i}"
      self.add_module(name, DistributionDense(self._output_in_dim(i), rv,
                                              generator))
      self.output_heads.append(getattr(self, name))

  #: layers beside the base heads that project in the compute dtype (the
  #: JAX module gives them ``dtype=compute_dtype``); every other Dense of a
  #: topology stays float32 and widens a bf16 input, as flax promotes it
  _compute_dtype_layers: Tuple[str, ...] = ()

  def set_compute_dtype(self, compute_dtype: Optional[str]) -> None:
    """The JAX module's ``compute_dtype`` ('bfloat16' or None): the latent
    and output heads and ``_compute_dtype_layers`` project in it; the
    encoder and decoder MLPs take theirs from their NetConfs. Parameter
    shapes do not depend on it, so it is set after construction."""
    dt = resolve_dtype(compute_dtype)
    layers = [h for h in self.latent_heads + self.output_heads
              if h is not None]
    layers += [getattr(self, n) for n in self._compute_dtype_layers
               if hasattr(self, n)]
    for layer in layers:
      if isinstance(layer, DistributionDense):
        layer.set_compute_dtype(compute_dtype)
      else:
        layer.compute_dtype = dt

  def _main_dim(self) -> int:
    """Width of the module input without the batch block."""
    return self.outputs[0].dim

  def _encoder_in_dim(self, i: int) -> int:
    """Input width of encoder ``i`` without the batch block: the whole
    module input (MULTIVI's encoders read one modality each)."""
    return self._main_dim()

  def _latent_head_source(self, i: int) -> Optional[int]:
    """The encoder feeding latent head ``i`` (extra heads reuse the last),
    or None for a head the forward never calls: flax creates no
    parameters for it, so neither does the port (MULTIVI's z)."""
    return min(i, len(self.encoders) - 1)

  def _decoder_in_dim(self) -> int:
    if self.reduce_latent == "concat":
      return sum(rv.dim for rv in self.latents)
    return self.latents[0].dim

  def _output_in_dim(self, i: int) -> int:
    """Input width of output head ``i`` (the decoder's hidden width)."""
    return self.decoders[0].out_dim

  def preprocess(self, x):
    return torch.log1p(x) if self.log_norm else x

  def split_batch(self, x):
    """(main input, batch block): the trailing one-hot block when the
    width is main + n_batch, else the uniform batch prior; (x, None)
    without batch conditioning. Any other width raises."""
    nb = self.n_batch
    if not nb:
      return x, None
    main = self._main_dim()
    if x.shape[-1] == main + nb:
      return x[..., :main], x[..., main:]
    if x.shape[-1] != main:
      raise ValueError(f"input width {x.shape[-1]} is neither {main} nor "
                       f"{main + nb} (n_batch={nb})")
    return x, self._uniform_batch(x)

  def _uniform_batch(self, like: torch.Tensor) -> torch.Tensor:
    return torch.full(tuple(like.shape[:-1]) + (self.n_batch,),
                      1.0 / self.n_batch, dtype=torch.float32,
                      device=like.device)

  def _with_batch(self, h, b):
    if b is None:
      return h
    b = b.expand(tuple(h.shape[:-1]) + (b.shape[-1],))
    return torch.cat([h, b.to(h.dtype)], dim=-1)

  def _decoder_input(self, z, batch):
    """z with the batch block (the uniform prior when none is given)."""
    if self.n_batch and batch is None:
      batch = self._uniform_batch(z)
    return self._with_batch(z, batch)

  def encode(self, x, generator=None) -> Tuple[D.Distribution, ...]:
    x, b = self.split_batch(x)
    h = self._with_batch(self.preprocess(x), b)
    hs = [enc(h, generator) for enc in self.encoders]
    return tuple(head(hs[min(i, len(hs) - 1)])
                 for i, head in enumerate(self.latent_heads))

  def reduce_latents(self, zs: Sequence[torch.Tensor]) -> torch.Tensor:
    if len(zs) == 1 or self.reduce_latent == "first":
      return zs[0]
    if self.reduce_latent == "concat":
      return torch.cat(tuple(zs), dim=-1)
    if self.reduce_latent == "sum":
      return sum(zs)
    if self.reduce_latent == "mean":
      return sum(zs) / len(zs)
    raise ValueError(f"unknown reduce_latent: {self.reduce_latent}")

  def decode(self, z, library=None, generator=None, batch=None):
    d = self.decoders[0](self._decoder_input(z, batch), generator)
    return tuple(head(d) for head in self.output_heads)

  def latent_priors(self, library=None, like: Optional[torch.Tensor] = None):
    return tuple(rv.create_prior(device=like.device, dtype=like.dtype)
                 for rv in self.latents)

  def _sample(self, qZ, sample_shape, generator, noise):
    """One reparameterized draw per latent, each ``noise`` entry passed
    through unchanged as that latent's ``eps`` (see the module docstring);
    a deterministic latent (DCA) returns its ``loc`` and takes no noise
    (its entry may be None). A ``NoiseRecorder`` records each draw."""
    if isinstance(noise, NoiseRecorder):
      noise = [noise.latent(q, sample_shape) for q in qZ]
    elif noise is not None and len(noise) != len(qZ):
      raise ValueError(f"{len(noise)} noise tensors for {len(qZ)} latents")
    return tuple(q.rsample(sample_shape, generator=generator,
                           eps=None if noise is None else noise[i])
                 for i, q in enumerate(qZ))

  def forward(self, x, library=None, sample_shape: Tuple[int, ...] = (),
              generator: Optional[torch.Generator] = None,
              noise: Optional[Sequence[torch.Tensor]] = None) -> VAEOutput:
    _, b = self.split_batch(x)
    qZ = self.encode(x, generator)
    zs = self._sample(qZ, sample_shape, generator, noise)
    pX = self.decode(self.reduce_latents(zs), library, generator, b)
    return VAEOutput(outputs=pX, latents=qZ, latent_samples=zs,
                     priors=self.latent_priors(library, like=x))


def with_library_prior(priors, library):
  """``priors`` with the last (library) latent's prior replaced by
  Normal(local_mean, sqrt(local_var)) from the per-cell (n, 2) library
  stats, when they are given (SCVI, TotalVI)."""
  priors = list(priors)
  if library is not None:
    mean, var = torch.chunk(library, 2, dim=-1)
    priors[-1] = D.Independent(D.Normal(loc=mean, scale=torch.sqrt(var)), 1)
  return tuple(priors)


class SCVIModule(VAEModule):
  """scVI topology (reference ``sisua/models/scvi.py:19-175``).

  * two encoders — z and library l; the library prior is
    ``Normal(local_mean, sqrt(local_var))`` from the per-cell stats;
  * only z is decoded; l is clipped to [0, clip_library];
  * the count head decodes in log space: log μ = l + log_softmax(scale)
    floored at log 1e-7; 'full' dispersion gives log θ = the raw
    Dispersion output (``NegativeBinomialLog``), 'single' a per-gene
    θ = exp(px_r_single) row that is never broadcast to (B, D)
    (``NegativeBinomialDispLog``); gate logits are raw;
  * extra (semi-supervised) label heads decode from the shared hidden d
    (``_label_heads``);
  * MeanScale, DropoutLogits and Dispersion project in the compute dtype
    and are cast back to float32 before the softmax and the likelihood.
  """

  _compute_dtype_layers = ("MeanScale", "DropoutLogits", "Dispersion")

  def __init__(self, outputs, latents, encoder_confs, decoder_confs,
               log_norm: bool = True, reduce_latent: str = "first",
               dispersion: str = "full", inflation: str = "full",
               clip_library: float = 1e3, n_batch: int = 0,
               generator: Optional[torch.Generator] = None):
    super().__init__(outputs, latents, encoder_confs, decoder_confs,
                     log_norm=log_norm, reduce_latent="first",
                     n_batch=n_batch, generator=generator)
    if dispersion not in ("full", "single"):
      raise ValueError(f"dispersion must be 'full' or 'single', got "
                       f"{dispersion!r}")
    self.dispersion = dispersion
    self.inflation = inflation
    self.clip_library = float(clip_library)
    n_dims = self.outputs[0].dim
    hidden = self.decoders[0].out_dim
    self.MeanScale = dense(hidden, n_dims, generator)
    if self.zero_inflated:
      self.DropoutLogits = dense(hidden, n_dims, generator)
    if dispersion == "full":
      self.Dispersion = dense(hidden, n_dims, generator)
    else:
      self.px_r_single = nn.Parameter(torch.zeros(n_dims))

  @property
  def zero_inflated(self) -> bool:
    return self.outputs[0].is_zero_inflated and self.inflation == "full"

  def latent_priors(self, library=None, like=None):
    return with_library_prior(super().latent_priors(library, like), library)

  def decode(self, latent_samples, library=None, generator=None, batch=None):
    z, l = latent_samples
    l = torch.clamp(l, 0.0, self.clip_library)
    d = self.decoders[0](self._decoder_input(z, batch), generator)
    log_scale = torch.clamp_min(
        F.log_softmax(self.MeanScale(d).to(torch.float32), dim=-1),
        _LOG_SCALE_FLOOR)
    log_rate = l + log_scale
    if self.dispersion == "full":
      nb = D.NegativeBinomialLog(
          log_loc=log_rate, log_disp=self.Dispersion(d).to(torch.float32))
    else:
      nb = D.NegativeBinomialDispLog(log_loc=log_rate,
                                     disp=torch.exp(self.px_r_single)[None])
    if self.zero_inflated:
      pX = D.Independent(D.ZeroInflated(
          count_distribution=nb,
          gate_logits=self.DropoutLogits(d).to(torch.float32)), 1)
    else:
      pX = D.Independent(nb, 1)
    return (pX,) + self._label_heads(d, z, generator)

  def _label_heads(self, d, z, generator=None) -> Tuple[D.Distribution, ...]:
    """The extra heads, from the shared hidden ``d`` (SCANVI reads its
    classifier on z instead)."""
    return tuple(head(d) for head in self.output_heads[1:])

  def forward(self, x, library=None, sample_shape=(), generator=None,
              noise=None) -> VAEOutput:
    _, b = self.split_batch(x)
    qZ = self.encode(x, generator)
    zs = self._sample(qZ, sample_shape, generator, noise)
    pX = self.decode(zs, library, generator, b)
    return VAEOutput(outputs=pX, latents=qZ, latent_samples=zs,
                     priors=self.latent_priors(library, like=x))
