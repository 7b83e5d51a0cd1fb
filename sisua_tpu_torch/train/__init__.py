"""sisua_tpu_torch.train — the training loop (counterpart of
``sisua_tpu.train``; checkpoint I/O is not ported yet)."""

from .trainer import ClippedAdam, Trainer, clip_by_global_norm_

__all__ = ["Trainer", "ClippedAdam", "clip_by_global_norm_"]
