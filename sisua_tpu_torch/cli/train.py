"""sisua-train for the port: config-driven (multi-)model training.

  python -m sisua_tpu_torch.cli.train model.name=vae dataset.name=synthetic
  python -m sisua_tpu_torch.cli.train model.name=sisua,dca -m --ncpu 2
  python -m sisua_tpu_torch.cli.train --config configs/presets/cortex_vae.yaml

``--device`` (default 'cuda'; 'cpu' on request) is where every model is
built, multirun children included. Exits non-zero when a config failed or
anything was written to the scoreboard's errors during the run.
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
  from ..train.experimenter import SisuaExperimenter
  argv = list(sys.argv[1:] if argv is None else argv)
  kwargs = {}
  config = _take(argv, "--config")  # e.g. configs/presets/cortex_vae.yaml
  if config is not None:
    kwargs["config_path"] = config
  kwargs["device"] = str(resolve_device(_take(argv, "--device") or "cuda"))
  exp = SisuaExperimenter(**kwargs)
  print("SisuaExperimenter:")
  print(" - save   :", exp.save_path)
  print(" - config :", exp.config_path)
  print(" - device :", exp.device)
  n_errors = len(exp.scoreboard.read_errors())
  results = exp.run(argv)
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
