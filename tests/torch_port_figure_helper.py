"""Reduce a matplotlib figure to what it draws, and compare two figures.

``reduce_figure(fig)`` gives, for the figure and each of its axes in
order: the titles, axis labels, fixed tick positions and labels, legend
texts; each line's x/y; each collection's offsets, sizes, colour array
and (when no colour array maps them) face colours, and its paths'
vertices; each patch's xy, width and height; each image's array; and the
text artists. ``assert_figures_equal(got, want, rtol, atol)`` holds two
reductions: strings, counts and fixed colours exactly, numbers within the
tolerance. ``offsets=False`` leaves the scatter positions out (the t-SNE
and UMAP scatters, held by trustworthiness instead); ``column_atol``
holds the offsets per column within that fraction of the column's range
(the PCA scatters).
"""

import numpy as np


def _fixed_ticks(axis):
  """(positions, labels) of fixed ticks, else (None, None)."""
  from matplotlib.ticker import FixedLocator
  loc, fmt = axis.get_major_locator(), axis.get_major_formatter()
  if not isinstance(loc, FixedLocator):
    return None, None
  locs = np.asarray(loc.locs, float)
  return locs, [str(fmt(v, i)) for i, v in enumerate(locs)]


def _collection(c):
  out = {"kind": type(c).__name__,
         "offsets": np.asarray(c.get_offsets(), float),
         "sizes": np.asarray(c.get_sizes(), float)
         if hasattr(c, "get_sizes") else None,
         "array": None if c.get_array() is None
         else np.asarray(c.get_array(), float),
         "label": str(c.get_label())}
  if c.get_array() is None:
    out["facecolors"] = np.asarray(c.get_facecolors(), float)
  paths = c.get_paths()
  out["paths"] = [np.asarray(p.vertices, float) for p in paths] \
      if len(paths) < 200 else None
  return out


def _axes(ax):
  xt, yt = _fixed_ticks(ax.xaxis), _fixed_ticks(ax.yaxis)
  leg = ax.get_legend()
  return {
      "title": ax.get_title(), "xlabel": ax.get_xlabel(),
      "ylabel": ax.get_ylabel(), "xticks": xt[0], "xticklabels": xt[1],
      "yticks": yt[0], "yticklabels": yt[1],
      "legend": None if leg is None else [t.get_text()
                                          for t in leg.get_texts()],
      "lines": [(np.asarray(l.get_xdata(), float),
                 np.asarray(l.get_ydata(), float)) for l in ax.get_lines()],
      "collections": [_collection(c) for c in ax.collections],
      "patches": [(np.asarray(p.get_xy(), float), float(p.get_width()),
                   float(p.get_height())) for p in ax.patches
                  if hasattr(p, "get_width")],
      "images": [np.asarray(im.get_array(), float) for im in ax.images],
      "texts": [(t.get_text(), tuple(map(float, t.get_position())))
                for t in ax.texts],
  }


def reduce_figure(fig):
  sup = fig._suptitle.get_text() if fig._suptitle is not None else None
  return {"suptitle": sup, "axes": [_axes(ax) for ax in fig.get_axes()]}


def _close(got, want, rtol, atol, where):
  if want is None or got is None:
    assert got is None and want is None, where
    return
  got, want = np.asarray(got, float), np.asarray(want, float)
  assert got.shape == want.shape, (where, got.shape, want.shape)
  np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                             err_msg=where, equal_nan=True)


def assert_figures_equal(got, want, rtol=1e-10, atol=1e-10, offsets=True,
                         column_atol=None, name=""):
  """``got`` and ``want`` are ``reduce_figure`` reductions."""
  assert got["suptitle"] == want["suptitle"], name
  assert len(got["axes"]) == len(want["axes"]), name
  for i, (g, w) in enumerate(zip(got["axes"], want["axes"])):
    at = f"{name} axes {i}"
    for k in ("title", "xlabel", "ylabel", "xticklabels", "yticklabels",
              "legend"):
      assert g[k] == w[k], (at, k, g[k], w[k])
    for k in ("xticks", "yticks"):
      _close(g[k], w[k], rtol, atol, f"{at} {k}")
    assert len(g["lines"]) == len(w["lines"]), at
    for j, ((gx, gy), (wx, wy)) in enumerate(zip(g["lines"], w["lines"])):
      _close(gx, wx, rtol, atol, f"{at} line {j} x")
      _close(gy, wy, rtol, atol, f"{at} line {j} y")
    assert len(g["collections"]) == len(w["collections"]), at
    for j, (gc, wc) in enumerate(zip(g["collections"], w["collections"])):
      cat = f"{at} collection {j}"
      assert gc["kind"] == wc["kind"] and gc["label"] == wc["label"], cat
      assert gc["offsets"].shape == wc["offsets"].shape, cat
      if offsets and column_atol is not None and len(wc["offsets"]):
        span = np.ptp(wc["offsets"], axis=0)
        assert np.all(np.abs(gc["offsets"] - wc["offsets"])
                      <= column_atol * span + atol), cat
      elif offsets:
        _close(gc["offsets"], wc["offsets"], rtol, atol, f"{cat} offsets")
      _close(gc["sizes"], wc["sizes"], rtol, atol, f"{cat} sizes")
      _close(gc["array"], wc["array"], rtol, atol, f"{cat} array")
      if "facecolors" in wc:
        np.testing.assert_array_equal(gc["facecolors"], wc["facecolors"],
                                      err_msg=f"{cat} colours")
      if offsets and wc["paths"] is not None and gc["paths"] is not None:
        assert len(gc["paths"]) == len(wc["paths"]), cat
        for p, (gp, wp) in enumerate(zip(gc["paths"], wc["paths"])):
          _close(gp, wp, rtol, atol, f"{cat} path {p}")
    assert len(g["patches"]) == len(w["patches"]), at
    for j, (gp, wp) in enumerate(zip(g["patches"], w["patches"])):
      _close(gp[0], wp[0], rtol, atol, f"{at} patch {j} xy")
      _close(gp[1:], wp[1:], rtol, atol, f"{at} patch {j} size")
    assert len(g["images"]) == len(w["images"]), at
    for j, (gi, wi) in enumerate(zip(g["images"], w["images"])):
      _close(gi, wi, rtol, atol, f"{at} image {j}")
    assert [t[0] for t in g["texts"]] == [t[0] for t in w["texts"]], at
    _close([t[1] for t in g["texts"]], [t[1] for t in w["texts"]], rtol,
           atol, f"{at} text positions")


def reduce_all(figures):
  """{name: reduction} of a figure sink's figures, in order."""
  return {k: reduce_figure(f) for k, f in figures.items()}
