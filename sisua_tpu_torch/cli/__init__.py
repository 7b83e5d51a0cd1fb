"""The port's command-line tools (counterpart of ``sisua_tpu.cli``). Each
runs on ``--device cuda`` unless asked for the CPU:

  python -m sisua_tpu_torch.cli.train model.name=sisua dataset.name=synthetic10k
  python -m sisua_tpu_torch.cli.predict <exp_dir>/model synthetic10k -o out
  python -m sisua_tpu_torch.cli.evaluate -model sisua -ds synthetic10k --no-plots
  python -m sisua_tpu_torch.cli.embed synthetic -o out --no-figures

The figures of ``evaluate`` and ``embed`` wait for the port's plotting
layer (ROADMAP A12c): both refuse to start without ``--no-plots`` /
``--no-figures``. ``showdata`` and ``cross_analyze`` are not ported.
"""
