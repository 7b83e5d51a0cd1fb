"""sisua_tpu_torch.data — the host-side data helpers the port needs,
without pandas (counterpart of ``sisua_tpu.data``)."""

from .feeder import DataFeeder
from .utils import get_library_size, int16_exact

__all__ = ["DataFeeder", "get_library_size", "int16_exact"]
