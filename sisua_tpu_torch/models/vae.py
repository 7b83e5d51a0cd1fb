"""VAE, SISUA, MISA — the paper's β-VAE family (port of
``sisua_tpu/models/vae.py``).

  * ``VAE``: plain β-VAE over a count likelihood.
  * ``SISUA``: multitask semi-supervised VAE. The first output is the
    transcriptomic reconstruction; the others are label (e.g. protein)
    heads whose log-likelihoods are weighted by α and gated in training by
    the per-cell Bernoulli(``labels_percent``) mask.
  * ``MISA``: SISUA with mixture label heads: each label RV is coerced to
    its mixture analogue ('mixnb', 'mixgaus', 'mdn') with ``n_components``
    (default 2) and, for 'mixnb', ``zero_inflated`` in its kwargs.
"""

from __future__ import annotations

from ..rv import parse_rv
from .base import SingleCellModel, _flatten

__all__ = ["VAE", "SISUA", "MISA"]


class VAE(SingleCellModel):
  """Unsupervised β-VAE over count likelihoods."""


class SISUA(SingleCellModel):
  """SemI-SUpervised generative Autoencoder: masked multitask VAE."""

  mask_outputs = True

  def __init__(self, outputs, **kwargs):
    outputs = _flatten(outputs)
    if len(outputs) < 2:
      raise ValueError("SISUA requires ≥2 outputs (transcriptomic + ≥1 "
                       f"label omic), given {len(outputs)}")
    super().__init__(outputs, **kwargs)


_MIXTURE_COERCE = {
    # any label posterior → its mixture analogue
    "nb": "mixnb", "nbd": "mixnb", "zinb": "mixnb", "zinbd": "mixnb",
    "normal": "mixgaus", "gaus": "mixgaus", "gaussian": "mixgaus",
    "diag": "mixgaus", "onehot": "onehot",  # categorical already a mixture
    # already-mixture posteriors stay put
    "mixnb": "mixnb", "mixgaus": "mixgaus", "mdn": "mdn",
    "mixtril": "mixtril",
}


class MISA(SISUA):
  """MIxture-posterior SISUA: label heads become mixture distributions."""

  def __init__(self, outputs, n_components: int = 2,
               zero_inflated: bool = False, **kwargs):
    outputs = [parse_rv(o, f"output{i}")
               for i, o in enumerate(_flatten(outputs))]
    coerced = [outputs[0]]
    for rv in outputs[1:]:
      post = _MIXTURE_COERCE.get(rv.posterior, "mdn")
      kw = dict(rv.kwargs)
      kw.setdefault("n_components", int(n_components))
      if post == "mixnb":
        kw.setdefault("zero_inflated", bool(zero_inflated))
      if post == "onehot":
        kw.pop("n_components", None)
      coerced.append(rv.replace(posterior=post,
                                kwargs=tuple(sorted(kw.items()))))
    super().__init__(tuple(coerced), **kwargs)
