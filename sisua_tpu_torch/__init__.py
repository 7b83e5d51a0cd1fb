"""sisua_tpu_torch — the PyTorch + CUDA port of sisua_tpu.

The JAX package ``sisua_tpu`` stays the reference; this package mirrors its
module layout and names (``dist``, ``rv``, ``nn``, ``ops``, ``models``,
``train``, ``data``) so each counterpart is found by path. It imports
``torch`` and never ``jax``, ``flax``, ``optax`` or ``pandas``, and nothing
from ``sisua_tpu``.

The fused ZINB/NB log-likelihood kernels (forward and backward) are CUDA
C++ in ``csrc/``, built with ``nvcc`` for ``sm_90a`` at first use and bound
with ``ctypes`` (``ops/_build.py``). On CPU tensors every kernel wrapper
runs its plain PyTorch version instead.

Port state: training (``fit`` with validation and early stopping),
``evaluate`` and serving (``predict``, ``predict_mean``,
``get_normalized_expression``, ``compute_llk``, ``marginal_log_prob``) of
SCVI and of the paper's VAE, SISUA, MISA and DeepCountAutoencoder
(``models``), with checkpoints the JAX package reads and writes
(``train/checkpoint.py``, ``models.load_model``).
"""

__version__ = "0.1.0"
