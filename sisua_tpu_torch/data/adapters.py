"""Adapters from the port's ``SingleCellOMIC`` to the models, which take
matrices: the feeders, matrices, ``fit`` and posterior the JAX models make
of a container (``sisua_tpu/models/base.py`` ``_to_feeder``).
"""

from __future__ import annotations

from typing import List

__all__ = ["sco_feeder", "sco_matrices", "fit_sco", "sco_posterior"]


def _output_omics(model, sco) -> List[str]:
  """The omics the model's outputs train on: by name when every output
  RV is named after an omic of ``sco`` (the experimenter names them so),
  else the first omics in order (the JAX ``_to_feeder``'s rule)."""
  avail = set(sco.omics)
  rv_names = [rv.name for rv in model.outputs]
  if all(n in avail for n in rv_names):
    return rv_names
  omics = list(sco.omics)[:len(model.outputs)]
  if any(n in avail for n in rv_names) and len(rv_names) > 1:
    import warnings
    warnings.warn(
        f"Output RV names {rv_names} only partially match the dataset's "
        f"omics {sorted(avail)}; falling back to the POSITIONAL omics "
        f"{omics}. Name every output RV after its omic to select by name.",
        stacklevel=3)
  return omics


def sco_feeder(model, sco, batch_size: int, labels_percent: float,
               shuffle: bool = True):
  """The ``DataFeeder`` the JAX ``fit`` makes of a ``SingleCellOMIC``:
  the output omics, the container's library statistics of the first,
  and the batch one-hot last when the model conditions on batches."""
  extra = [model._batch_onehot(sco)] if model.n_batch else None
  return sco.create_dataset(omics=_output_omics(model, sco),
                            labels_percent=labels_percent,
                            batch_size=batch_size, shuffle=shuffle,
                            extra_matrices=extra)


def sco_matrices(model, sco) -> list:
  """The matrices the model serves from a ``SingleCellOMIC``, as
  ``sco_feeder`` picks them (the JAX ``predict`` on a container)."""
  mats = [sco.get_omic(o) for o in _output_omics(model, sco)]
  if model.n_batch:
    mats.append(model._batch_onehot(sco))
  return mats


def fit_sco(model, train, valid=None, batch_size: int = 64,
            labels_percent: float = 0.0, **fit_kwargs):
  """``model.fit`` on ``SingleCellOMIC``s, as the JAX ``fit`` takes them:
  the model records the training container's var names, and trains on
  the feeders of ``sco_feeder``."""
  model.set_metadata(train)
  lp = labels_percent if model.is_semi_supervised else 0.0
  valid_feeder = (sco_feeder(model, valid, batch_size, 1.0, shuffle=False)
                  if valid is not None else None)
  return model.fit(sco_feeder(model, train, batch_size, lp),
                   valid=valid_feeder, batch_size=batch_size,
                   labels_percent=labels_percent, **fit_kwargs)


def sco_posterior(model, sco, **kwargs):
  """``model.create_posterior`` on a ``SingleCellOMIC``: its matrices and
  var names, the posterior named ``<model id>_<dataset name>`` as the JAX
  hub names it."""
  post = model.create_posterior(
      {o: sco.get_omic(o) for o in sco.omics},
      var_names={o: sco.get_var_names(o) for o in sco.omics}, **kwargs)
  post.name = f"{model.id}_{sco.name}"
  return post
