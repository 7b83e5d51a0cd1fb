"""The tutorials on the port (counterparts of ``tutorials/``), each a
module with ``main(device=None, out_dir=None, depth=None, figures=False)``
that runs on the card unless given ``device='cpu'`` and returns a dict of
what it prints, and a command line:

  python -m sisua_tpu_torch.tutorials.<name> [--device cpu] [--out DIR]
      [--depth N] [--figures]
"""

TUTORIALS = ("basics", "serving", "save_and_load_models",
             "uncertainty_analysis", "missing_protein",
             "probabilistic_embedding", "cross_datasets", "multiple_models",
             "qc_annotation", "performance", "bayes_search", "grid_search",
             "real_data_drill")

__all__ = ["TUTORIALS"]
