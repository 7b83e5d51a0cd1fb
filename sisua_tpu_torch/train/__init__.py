"""sisua_tpu_torch.train — the training loops, the vmapped ensemble,
checkpoint I/O, and the experiment manager with its sqlite scoreboard
(counterpart of ``sisua_tpu.train``)."""

from .checkpoint import (decode_spec, encode_spec, load_metamodel,
                         load_weights, save_metamodel, save_weights)
from .ensemble import VmapEnsemble
from .experimenter import Experimenter, SisuaExperimenter
from .scoreboard import ScoreBoard
from .trainer import (ClippedAdam, ClippedOptimizer, Trainer, TrainingCallback,
                      clip_by_global_norm_)

__all__ = ["Trainer", "TrainingCallback", "VmapEnsemble", "ClippedOptimizer",
           "ClippedAdam", "clip_by_global_norm_", "save_weights",
           "load_weights", "save_metamodel", "load_metamodel", "encode_spec",
           "decode_spec", "ScoreBoard", "Experimenter", "SisuaExperimenter"]
