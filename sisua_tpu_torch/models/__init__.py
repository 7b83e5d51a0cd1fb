"""sisua_tpu_torch.models — the port's models (counterpart of
``sisua_tpu.models``): SCVI and LDVAE, the paper's own VAE, SISUA, MISA and
DeepCountAutoencoder, SCALE/SCALAR, FVAE/SemiFVAE, TotalVI, SCANVI, PEAKVI,
MULTIVI, SCScope and AUTOZI (every one takes ``n_batch`` conditioning),
with ``get_model``, ``get_all_models`` and ``load_model`` over them.
``load_model`` reads a checkpoint written by either package. SOLO (doublet
detection on a trained model) and CellAssign (marker-based annotation) are
not ``SingleCellModel``s and are left out of ``get_all_models``, as in the
JAX package."""

from __future__ import annotations

import inspect
from typing import List, Type, Union

import torch

from .. import interpolation
from ..interpolation import Interpolation
from ..nn import NetConf
from ..rv import RVmeta
from ..train.checkpoint import load_metamodel
from .autozi import AUTOZI, AUTOZIModule
from .base import SingleCellModel
from .cellassign import CellAssign
from .dca import DeepCountAutoencoder
from .fvae import FVAE, SemiFVAE
from .ldvae import LDVAE
from .module import SCVIModule, VAEModule, VAEOutput
from .multivi import MULTIVI, MULTIVIModule
from .objective import compute_loss, elbo_terms
from .peakvi import PEAKVI, PEAKVIModule
from .scale import SCALAR, SCALE
from .scanvi import SCANVI, SCANVIModule
from .scscope import SCScope, SCScopeModule
from .scvi import SCVI
from .solo import SOLO
from .totalvi import TotalVI, TotalVIModule
from .vae import MISA, SISUA, VAE

__all__ = ["SingleCellModel", "VAE", "SISUA", "MISA", "DeepCountAutoencoder",
           "SCVI", "LDVAE", "SCALE", "SCALAR", "FVAE", "SemiFVAE", "TotalVI",
           "SCANVI", "PEAKVI", "MULTIVI", "SCScope", "AUTOZI", "SOLO",
           "CellAssign", "get_model", "get_all_models", "load_model",
           "SCVIModule", "VAEModule", "VAEOutput", "SCScopeModule",
           "AUTOZIModule", "TotalVIModule", "SCANVIModule", "PEAKVIModule",
           "MULTIVIModule", "compute_loss", "elbo_terms", "NetConf",
           "RVmeta", "Interpolation", "interpolation"]


_PORTED = (VAE, SISUA, MISA, DeepCountAutoencoder, SCVI, LDVAE, SCALE,
           SCALAR, FVAE, SemiFVAE, TotalVI, SCANVI, PEAKVI, MULTIVI, SCScope,
           AUTOZI)


def get_all_models() -> List[Type[SingleCellModel]]:
  """The ported concrete models."""
  return list(_PORTED)


def get_model(name) -> Type[SingleCellModel]:
  """Resolve a model class by class name or id ('dca', 'sisua', …): the
  lower-cased capital letters of the class name, as the JAX package."""
  if inspect.isclass(name) and issubclass(name, SingleCellModel):
    return name
  key = str(name).strip().lower()
  for cls in _PORTED:
    cls_id = "".join(c for c in cls.__name__ if c.isupper()).lower()
    if key in (cls.__name__.lower(), cls_id):
      return cls
  raise ValueError(
      f"Cannot find model '{name}' among the ported models: "
      f"{sorted(c.__name__ for c in _PORTED)}")


def load_model(path: str, device: Union[str, torch.device] = "cuda"
               ) -> SingleCellModel:
  """Rebuild a model from <path>/metamodel.json on ``device`` and load its
  weights (``history.json`` too, when present)."""
  class_name, dataset, metadata, init_kwargs = load_metamodel(path)
  kwargs = dict(init_kwargs)
  outputs = kwargs.pop("outputs")
  model = get_model(class_name)(outputs, dataset=dataset, metadata=metadata,
                                device=device, **kwargs)
  return model.load_weights(path, raise_notfound=True)
