#!/usr/bin/env python3
"""The ZINB kernels of this checkout against those of other checkouts, on
one CUDA card, in one process.

    python3 tools/zinb_kernel_ab.py OTHER_ROOT [OTHER_ROOT ...]

Each OTHER_ROOT is a checkout of this repository, for example an earlier
commit unpacked with ``git archive`` into the git-ignored ``build/``
directory, or a copy built with other compiler flags. Its
``sisua_tpu_torch/ops`` is loaded under another package name and builds
its own library into ``OTHER_ROOT/build/kernels``. Then:

  1. every phase-3 case of ``chip_smoke.py``: each version against the
     plain version at phase 3's tolerances, twice for the same bits,
     whether this version's outputs equal the other's bit for bit, then
     µs per call of the other version and of this one in turns (other,
     this, this, other; ROUNDS times), beside the case's bound;
  2. main_full operands (512 × 33,000) at nonzero shares 0, 0.5%, 7% and
     100%: the count path's cost;
  3. each library's SASS instructions per kernel (``cuobjdump -sass``), and
     beside each time the lane instructions per element that the time
     would issue at full rate (each SM's 4 schedulers issuing one warp
     instruction per clock at the card's maximum SM clock), and the host
     µs per call of each wrapper (calls queued without a wait).

Prints the card's name and power limit first; writes everything also to
``chiprun_out/zinb_kernel_ab.txt``. Imports nothing of JAX.
"""

import importlib
import importlib.util
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHARES = (0.0, 0.005, 0.07, 1.0)
ROUNDS = 10  # turns per version: the small cases are host-bound and noisy
_LINES = []


def log(msg):
  print(msg, flush=True)
  _LINES.append(msg)


def load_ops(root, name):
  """``root``'s ``sisua_tpu_torch.ops`` as package ``name``: (zinb,
  _build)."""
  pkg = os.path.join(root, "sisua_tpu_torch", "ops")
  spec = importlib.util.spec_from_file_location(
      name, os.path.join(pkg, "__init__.py"),
      submodule_search_locations=[pkg])
  mod = importlib.util.module_from_spec(spec)
  sys.modules[name] = mod
  spec.loader.exec_module(mod)
  return (importlib.import_module(f"{name}.zinb"),
          importlib.import_module(f"{name}._build"))


def sass_counts(lib_path):
  """{kernel function: (SASS instructions, zero-path span)} of one shared
  library. The span is the instructions from a warp's wait for its tile
  (the first ``DEPBAR``) to its first ballot (``VOTE``): the per-tile work
  before the count path, for the 4 elements of a lane; None in a kernel
  without that shape."""
  text = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass",
                         str(lib_path)], capture_output=True, text=True,
                        check=True).stdout
  funcs, name = {}, None
  for line in text.splitlines():
    m = re.match(r"\s+Function : (\S+)", line)
    if m:
      name = m[1]
      funcs[name] = []
    elif name:
      m = re.match(r"\s+/\*[0-9a-f]{4}\*/\s+(.*?);", line)
      if m:
        funcs[name].append(m[1])
  out = {}
  for name, ins in funcs.items():
    wait = next((i for i, s in enumerate(ins) if "DEPBAR.LE" in s), None)
    vote = next((i for i, s in enumerate(ins)
                 if wait is not None and i > wait and "VOTE" in s), None)
    out[name] = (len(ins), None if vote is None else vote - wait - 1)
  return out


def _smi(query):
  return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                         "--format=csv,noheader,nounits"],
                        capture_output=True, text=True,
                        timeout=60).stdout.strip().splitlines()[0]


def _sparse_x(torch, gen, share):
  x = cs._counts(torch, gen, cs.BATCH, cs.GENES)
  keep = torch.rand(x.shape, generator=gen, device=cs.DEVICE) < share
  return torch.where(keep, x + 1.0, torch.zeros_like(x))


def _host_us(torch, fn, calls=200):
  """Host µs per call: ``calls`` calls queued without a wait (the launch
  queue holds them), then one synchronize outside the clock."""
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  for _ in range(calls):
    fn()
  dt = time.perf_counter() - t0
  torch.cuda.synchronize()
  return dt / calls * 1e6


def main(others):
  import torch
  if not torch.cuda.is_available():
    print("zinb_kernel_ab: no CUDA device", file=sys.stderr)
    return 2
  log(f"[card] {_smi('name,power.limit')} | max SM clock MHz "
      f"{_smi('clocks.max.sm')}")
  clock = float(_smi("clocks.max.sm")) * 1e6
  n_sm = torch.cuda.get_device_properties(0).multi_processor_count
  mine = load_ops(ROOT, "ab_this")
  versions = [(os.path.relpath(r, ROOT), load_ops(r, f"ab_other{i}"))
              for i, r in enumerate(others)]
  for label, (_, build) in [("this", mine)] + versions:
    lib = build.build()
    log(f"[build] {label}: {lib}")
    for fn, (n, span) in sorted(sass_counts(lib).items()):
      zero = "" if span is None else (
          f", {span} from tile wait to first ballot = {span / 4:.0f} per "
          "element")
      log(f"[sass] {label}: {n:6d} instructions{zero}  {fn}")

  def issue(us, elems):  # lane instructions per element a time would allow
    return us * 1e-6 * n_sm * 4 * clock / (elems / 32)

  gen = torch.Generator(device=cs.DEVICE).manual_seed(cs.SEED)
  for name, rows, cols, constrained, pg in cs.CASES:
    if name == "extreme":
      x, cr, lg, gt = cs._extreme_case(torch)
    else:
      x, cr, lg, gt = cs._case(torch, gen, name, rows, cols, constrained, pg)
    g = torch.randn((x.shape[0],), generator=gen, device=cs.DEVICE)
    need = (True, True, name not in cs.NB_GATE_CASES)
    bounds = cs.kernel_bounds(x, cr, lg, gt, need)
    sweep = [(f"{name}", x)]
    if name == "main_full":
      sweep += [(f"{name}@nonzero={s}", _sparse_x(torch, gen, s))
                for s in SHARES]
    for label, xs in sweep:
      for other, (tz_o, _) in versions:
        for tz in (mine[0], tz_o):
          cs.check_kernels(torch, tz, label, xs, cr, lg, gt, g, constrained,
                           need)
        outs = [(tz._fwd_launch(xs, cr, lg, gt, constrained),
                 tz._bwd_launch(xs, cr, lg, gt, g, constrained, need))
                for tz in (mine[0], tz_o)]
        same = torch.equal(outs[0][0], outs[1][0]) and all(
            (a is None and b is None) or torch.equal(a, b)
            for a, b in zip(outs[0][1], outs[1][1]))
        log(f"[bits] {label}: this version's forward and gradients "
            f"{'equal' if same else 'DIFFER from'} {other}'s bit for bit")
        del outs
        for kind in ("fwd", "bwd"):
          if kind == "fwd":
            fns = {"plain": lambda t=tz_o: t._fwd_launch(xs, cr, lg, gt,
                                                          constrained),
                   "kernel": lambda: mine[0]._fwd_launch(xs, cr, lg, gt,
                                                         constrained)}
          else:
            fns = {"plain": lambda t=tz_o: t._bwd_launch(
                       xs, cr, lg, gt, g, constrained, need),
                   "kernel": lambda: mine[0]._bwd_launch(
                       xs, cr, lg, gt, g, constrained, need)}
          t = cs._time_turns(torch, fns, rounds=ROUNDS)
          host = {k: _host_us(torch, f) for k, f in fns.items()}
          b = bounds[kind][0]
          log(f"[{kind}] {label} {tuple(xs.shape)} nonzero "
              f"{float((xs > 0).float().mean()):.4f}: this "
              f"{t['kernel']:.1f} µs ({b / t['kernel']:.1%} of bound "
              f"{b:.1f} µs, {issue(t['kernel'], xs.numel()):.0f} issue "
              f"slots/elem) | {other} {t['plain']:.1f} µs "
              f"({b / t['plain']:.1%}, "
              f"{issue(t['plain'], xs.numel()):.0f}) | this/other "
              f"{t['kernel'] / t['plain']:.3f} | host µs/call this "
              f"{host['kernel']:.1f} {other} {host['plain']:.1f}")
    del x, cr, lg, gt, sweep
  os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
  with open(os.path.join(ROOT, "chiprun_out", "zinb_kernel_ab.txt"),
            "w") as f:
    f.write("\n".join(_LINES) + "\n")
  return 0


if __name__ == "__main__":
  sys.path.insert(0, ROOT)
  import chip_smoke as cs
  sys.exit(main([os.path.abspath(r) for r in sys.argv[1:]]))
