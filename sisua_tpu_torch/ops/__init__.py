"""sisua_tpu_torch.ops — the port's hand-written CUDA kernels for the ELBO
hot path (counterpart of ``sisua_tpu.ops``). On CPU tensors every wrapper
runs its kernel's plain PyTorch version."""

from .zinb import (kernels_available, launches, nb_log_prob_rowsum,
                   reset_launches, zinb_log_prob_rowsum)

__all__ = ["zinb_log_prob_rowsum", "nb_log_prob_rowsum", "kernels_available",
           "launches", "reset_launches"]
