"""SCALE / SCALAR — VAEs with a Gaussian-mixture latent (port of
``sisua_tpu/models/scale.py``).

  * ``SCALE``: the latent posterior is coerced to 'mixgaus' with
    ``n_components`` (default 10); 'mixtril' and 'mdn' latents are kept.
    ``analytic=False`` is forced: a mixture has no closed-form KL to the
    unit-normal prior, so the objective takes the Monte-Carlo estimate
    from the forward's reparameterized draw.
  * ``SCALAR``: SCALE with SISUA's semi-supervised masked label heads.
"""

from __future__ import annotations

from ..rv import RVmeta, parse_rv
from .base import SingleCellModel, _flatten

__all__ = ["SCALE", "SCALAR"]

_MIXTURE_LATENTS = ("mixgaus", "mixtril", "mdn")


def _coerce_mixture_latents(latents, n_components: int):
  if latents is None:
    latents = RVmeta(10, "mixgaus", True, "latents",
                     (("n_components", int(n_components)),))
  out = []
  for i, z in enumerate(_flatten(latents)):
    z = parse_rv(z, f"latent{i}")
    if z.posterior not in _MIXTURE_LATENTS:
      kw = dict(z.kwargs)
      kw.setdefault("n_components", int(n_components))
      z = z.replace(posterior="mixgaus", kwargs=tuple(sorted(kw.items())))
    out.append(z)
  return tuple(out)


class SCALE(SingleCellModel):
  """Single-Cell ATAC-seq analysis via Latent feature Extraction: a VAE
  whose latent is a Gaussian mixture."""

  def __init__(self, outputs, latents=None, n_components: int = 10,
               **kwargs):
    kwargs["analytic"] = False
    super().__init__(outputs,
                     latents=_coerce_mixture_latents(latents, n_components),
                     **kwargs)


class SCALAR(SCALE):
  """SCALE with semi-supervised (masked) label heads."""

  mask_outputs = True

  def __init__(self, outputs, **kwargs):
    outputs = _flatten(outputs)
    if len(outputs) < 2:
      raise ValueError("SCALAR requires ≥2 outputs (main omic + ≥1 label "
                       f"omic), given {len(outputs)}")
    super().__init__(outputs, **kwargs)
