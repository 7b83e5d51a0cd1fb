"""SCVI — single-cell variational inference (Lopez et al. 2018), port of
``sisua_tpu/models/scvi.py``: the spec coercions and defaults around
``SCVIModule``.

Two encoders (z and library l), latents ``[z_rv, RVmeta(1, 'normal',
'library')]``, a main output that must be 'zinbd' or 'nbd' and is decoded
directly (``projection=False``), dispersion 'full' (per cell and gene) or
'single' (per gene). Extra outputs are label heads decoded from the shared
hidden state (weighted by ``alpha``, unmasked: SCVI is not
semi-supervised).
"""

from __future__ import annotations

from ..nn import NetConf, parse_netconf
from ..rv import RVmeta, parse_rv
from .base import SingleCellModel, _flatten
from .module import SCVIModule

__all__ = ["SCVI"]


class SCVI(SingleCellModel):

  module_cls = SCVIModule

  def __init__(self,
               outputs,
               latents=None,
               library=None,
               encoder=None,
               encoder_l=None,
               clip_library: float = 1e3,
               **kwargs):
    outputs = [parse_rv(o, f"output{i}")
               for i, o in enumerate(_flatten(outputs))]
    if outputs[0].posterior not in ("zinbd", "nbd"):
      raise ValueError("scVI only supports transcriptomic distribution "
                       f"'zinbd' or 'nbd', given: {outputs[0].posterior}")
    self.dispersion = kwargs.pop(
        "dispersion", outputs[0].kw.get("dispersion", "full"))
    self.inflation = kwargs.pop(
        "inflation", outputs[0].kw.get("inflation", "full"))
    kwargs.pop("reduce_latent", None)  # always 'first' for SCVI
    # a metamodel rebuild passes the assembled (z, library) and
    # (encoder, encoder_l) pairs back in
    if isinstance(latents, (tuple, list)) and len(latents) == 2 \
        and library is None:
      latents, library = latents
    if isinstance(encoder, (tuple, list)) and len(encoder) == 2 \
        and encoder_l is None:
      encoder, encoder_l = encoder
    outputs[0] = outputs[0].replace(projection=False)
    if latents is None:
      latents = RVmeta(10, "diag", True, "latents")
    latents = parse_rv(latents, "latents")
    if library is None:
      library = RVmeta(1, "normal", True, "library")
    library = parse_rv(library, "library")
    if encoder is None:
      encoder = NetConf((64, 64), batchnorm=True, dropout=0.1, name="encoder")
    if encoder_l is None:
      encoder_l = NetConf((64,), batchnorm=True, dropout=0.1,
                          name="encoder_l")
    super().__init__(tuple(outputs), latents=(latents, library),
                     encoder=(parse_netconf(encoder, "encoder"),
                              parse_netconf(encoder_l, "encoder_l")),
                     reduce_latent="first",
                     clip_library=float(clip_library),
                     dispersion=self.dispersion,
                     inflation=self.inflation,
                     **kwargs)

  @property
  def uses_library(self) -> bool:
    return True
