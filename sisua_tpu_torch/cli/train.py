"""sisua-train for the port: config-driven (multi-)model training.

  python -m sisua_tpu_torch.cli.train model.name=vae dataset.name=synthetic
  python -m sisua_tpu_torch.cli.train model.name=sisua,dca -m --ncpu 2
  python -m sisua_tpu_torch.cli.train --config configs/presets/cortex_vae.yaml

``--device`` (default 'cuda'; 'cpu' on request) is where every model is
built, multirun children included. A config with ``train.n_data_devices ×
train.n_model_devices`` > 1 trains over that mesh: under torchrun the
process joins its world; otherwise the command starts a world of that
many ranks here (``cli/_world.py``), and rank 0 writes and prints. Exits
non-zero when a config failed or anything was written to the
scoreboard's errors during the run.
"""

from __future__ import annotations

import sys


def _take(argv, flag: str):
  """Remove ``flag VALUE`` from argv and return VALUE (None if absent)."""
  if flag not in argv:
    return None
  i = argv.index(flag)
  if i + 1 >= len(argv):
    raise SystemExit(f"{flag} requires a value argument")
  value = argv[i + 1]
  del argv[i:i + 2]
  return value


def main(argv=None):
  from ..models.base import resolve_device
  from ..parallel import is_main_rank
  from ..train.experimenter import SisuaExperimenter, _mesh_shape
  from . import _world
  argv = list(sys.argv[1:] if argv is None else argv)
  given = list(argv)
  kwargs = {}
  config = _take(argv, "--config")  # e.g. configs/presets/cortex_vae.yaml
  if config is not None:
    kwargs["config_path"] = config
  kwargs["device"] = str(resolve_device(_take(argv, "--device") or "cuda"))
  exp = SisuaExperimenter(**kwargs)
  if not _world.joined():
    ranks = max(a * b for a, b in map(_mesh_shape,
                                      exp.parse_args(list(argv))[0]))
    if ranks > 1:
      return _world.start(main, given, ranks, kwargs["device"])
  main_rank = is_main_rank()
  if main_rank:
    print("SisuaExperimenter:")
    print(" - save   :", exp.save_path)
    print(" - config :", exp.config_path)
    print(" - device :", exp.device)
  n_errors = len(exp.scoreboard.read_errors())
  results = exp.run(argv)
  if not main_rank:
    return results
  for r in results:
    keys = [k for k in r if k.startswith(("llk", "imputation", "pearson",
                                          "spearman"))][:6]
    print("scores:", {k: round(float(r[k]), 4) for k in keys})
  failed = [r["error"] for r in results if "error" in r]
  new_errors = exp.scoreboard.read_errors()[n_errors:]
  if failed or new_errors:
    for e in new_errors:
      print(f"[error] {e['uid']}: {e['message'].splitlines()[0]}",
            file=sys.stderr)
    raise SystemExit(f"{len(failed)} config(s) failed, {len(new_errors)} "
                     f"error(s) on the scoreboard {exp.scoreboard.path}")
  return results


if __name__ == "__main__":
  main()
