"""sisua_tpu_torch.data — the host-side data helpers the port needs,
without pandas (counterpart of ``sisua_tpu.data``)."""

from .const import MARKER_ADT_GENE, MARKER_ADTS
from .feeder import DataFeeder
from .utils import (apply_artificial_corruption, get_library_size,
                    int16_exact, standardize_protein_name)

__all__ = ["DataFeeder", "get_library_size", "int16_exact",
           "apply_artificial_corruption", "standardize_protein_name",
           "MARKER_ADT_GENE", "MARKER_ADTS"]
