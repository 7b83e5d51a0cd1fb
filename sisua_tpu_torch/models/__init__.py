"""sisua_tpu_torch.models — the port's models (counterpart of
``sisua_tpu.models``; SCVI so far)."""

from ..nn import NetConf
from ..rv import RVmeta
from .base import SingleCellModel
from .module import SCVIModule, VAEModule, VAEOutput
from .objective import compute_loss, elbo_terms
from .scvi import SCVI

__all__ = ["SingleCellModel", "SCVI", "SCVIModule", "VAEModule",
           "VAEOutput", "compute_loss", "elbo_terms", "NetConf", "RVmeta"]
