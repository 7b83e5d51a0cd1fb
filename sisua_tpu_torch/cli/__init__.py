"""The port's command-line tools (counterpart of ``sisua_tpu.cli``). Each
runs on ``--device cuda`` unless asked for the CPU:

  python -m sisua_tpu_torch.cli.train model.name=sisua dataset.name=synthetic10k
  python -m sisua_tpu_torch.cli.predict <exp_dir>/model synthetic10k -o out
  python -m sisua_tpu_torch.cli.evaluate -model sisua -ds synthetic10k
  python -m sisua_tpu_torch.cli.embed synthetic -o out
  python -m sisua_tpu_torch.cli.showdata -ds synthetic10k --figures

``evaluate``, ``embed`` and ``showdata --figures`` write figures, which
need matplotlib (and seaborn): without them each stops before any work
(``--no-plots`` / ``--no-figures`` leave the figures out).
``sisua_tpu_torch.cross_analyze`` evaluates models across datasets.
"""
