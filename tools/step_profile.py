#!/usr/bin/env python3
"""Where a training step's time goes, for the models of ``chip_smoke.py``
at 512 × 33,000, on one CUDA card.

    python3 tools/step_profile.py [MODEL ...]

MODEL is one of SISUA, FVAE, SCALAR, SCALE, LDVAE, phase 10's
scvi_batch (SCVI at n_batch = 4 with an 'nb' label head), totalvi and
scanvi, phase 11's peakvi and multivi (on 108,377 peaks with mosaic
cells), phase 12's autozi and scscope (its 33,000 × 33,000 imputer), and
phase 4's and phase 13's SCVI: scvi (float32), scvi_bf16
(``compute_dtype='bfloat16'``, SISUA_TPU_FWD_OPERANDS=bf16),
scvi_bf16_f32_operands and scvi_bf16_writes (f32 operands,
SISUA_TPU_BWD_WRITES=bf16) (default: all), built as ``chip_smoke.py``
builds it. For each:
one warm-up epoch of 8 steps through ``fit``, then STEPS steps of
``_train_step`` on fixed batches:
  * wall ms per step (host clock around the steps, ending in a
    synchronize), median of ROUNDS rounds;
  * under ``torch.profiler`` over STEPS steps: device-busy ms per step
    (the sum of the device operations' times: kernels, copies, fills),
    the idle share of the wall time, device operations per step, and the
    ones that take the most device time;
  * for a model with an aux step (FVAE): the wall ms per step without it,
    in turns with the full step.
Prints the card's name and power limit first; writes everything also to
``chiprun_out/step_profile.txt``. Imports nothing of JAX.
"""

import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 8
ROUNDS = 5
_LINES = []


def log(msg):
  print(msg, flush=True)
  _LINES.append(msg)


def _wall_ms(torch, model, batches):
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  for b in batches:
    model._train_step(b)
  torch.cuda.synchronize()
  return (time.perf_counter() - t0) / len(batches) * 1e3


def _union_us(ranges) -> float:
  """Length of the union of time intervals, µs."""
  total, end = 0.0, None
  for r in sorted(ranges, key=lambda r: r.start):
    if end is None or r.start > end:
      total += r.end - r.start
      end = r.end
    elif r.end > end:
      total += r.end - end
      end = r.end
  return total


# phase 10's models by the names this tool takes
PHASE10 = {"scvi_batch": "SCVI_batch", "totalvi": "TotalVI",
           "scanvi": "SCANVI"}
PHASE11 = {"peakvi": "PEAKVI", "multivi": "MULTIVI"}
PHASE12 = {"autozi": "AUTOZI", "scscope": "SCScope"}
# phase 4's and phase 13's SCVI: compute dtype and chip_smoke.BF16_MODES
SCVI = {"scvi": (None, "f32 operands"),
        "scvi_bf16": ("bfloat16", "bf16 operands"),
        "scvi_bf16_f32_operands": ("bfloat16", "f32 operands"),
        "scvi_bf16_writes": ("bfloat16", "f32 operands, bf16 writes")}
ALL = ["SISUA", "FVAE", "SCALAR", "SCALE", "LDVAE", *PHASE10, *PHASE11,
       *PHASE12, *SCVI]


def _model(cs, name):
  if name == "SISUA":
    from sisua_tpu_torch.models import SISUA
    return SISUA(cs._sisua_outputs(), alpha=cs.ALPHA, device=cs.DEVICE,
                 seed=cs.SEED)
  if name in PHASE10:
    return cs._phase10_model(PHASE10[name])
  if name in PHASE11:
    return cs._multiome_model(PHASE11[name])
  if name in PHASE12:
    return cs._phase12_model(PHASE12[name])
  if name in SCVI:
    return cs._scvi(None, "full", compute_dtype=SCVI[name][0])
  return cs._zoo_model(name)


def _inputs(cs, name, data, rows):
  """The model's data matrices, rows ``rows``."""
  x, y, b, ct, xm, a = (None if m is None else m[rows] for m in data)
  if name in PHASE10:
    return cs._phase10_inputs(PHASE10[name], x, y, b, ct)
  if name in PHASE11:
    return cs._multiome_inputs(PHASE11[name], xm, a, b)
  return [x, y] if name in ("SISUA", "SCALAR") else [x]


def profile(torch, cs, name, data):
  from torch.profiler import ProfilerActivity
  from sisua_tpu_torch.data import get_library_size
  model = _model(cs, name)
  n = 8 * cs.BATCH
  model.fit(_inputs(cs, name, data, slice(0, n)), epochs=1,
            batch_size=cs.BATCH, labels_percent=cs.LABELS_PERCENT,
            learning_rate=cs.SCSCOPE_LR if name == "scscope" else 1e-3,
            device_cache=True)
  batches = []
  for i in range(STEPS):
    rows = slice(i * cs.BATCH, (i + 1) * cs.BATCH)
    b = {"inputs": _inputs(cs, name, data, rows),
         "mask": (torch.arange(cs.BATCH, device=cs.DEVICE) % 10
                  == 0).float()}
    if model.uses_library:
      b["library"] = torch.cat(get_library_size(b["inputs"][0]), 1)
    batches.append(b)
  walls = [_wall_ms(torch, model, batches) for _ in range(ROUNDS)]
  with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                          ProfilerActivity.CUDA],
                              acc_events=True) as prof:
    _wall_ms(torch, model, batches)
  # device-side spans of annotations (``Optimizer.step#Adam.step``) hold
  # the kernels they cover: only the operations themselves count, and
  # busy time is the union of their intervals
  dev = [e for e in prof.events()
         if e.device_type == torch.autograd.DeviceType.CUDA]
  spans = [e for e in dev if e.is_user_annotation or "#" in e.name]
  ops = [(e.name, e.time_range.elapsed_us()) for e in dev
         if e not in spans]
  busy = _union_us([e.time_range for e in dev if e not in spans]) \
      / 1e3 / STEPS
  wall = statistics.median(walls)
  log(f"{name}: wall {wall:.3f} ms/step (rounds "
      f"{', '.join(f'{w:.3f}' for w in walls)}); device busy {busy:.3f} "
      f"ms/step (sum of operation times "
      f"{sum(t for _, t in ops) / 1e3 / STEPS:.3f}), idle "
      f"{1 - busy / wall:.1%}; {len(ops) / STEPS:.0f} device operations "
      f"and {len(spans) / STEPS:.0f} annotation spans per step")
  by_name = {}
  for k, t in ops:
    by_name[k] = by_name.get(k, 0.0) + t
  total = sum(by_name.values())
  for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
    log(f"  {v / total:6.1%} {v / 1e3 / STEPS:7.3f} ms/step  {k[:110]}")
  if model.aux is not None:
    full, bare = [], []
    aux_step = model._aux_step
    for _ in range(ROUNDS):
      for with_aux, acc in ((True, full), (False, bare), (False, bare),
                            (True, full)):
        model._aux_step = aux_step if with_aux else (lambda b, m: m)
        acc.append(_wall_ms(torch, model, batches))
    model._aux_step = aux_step
    log(f"{name}: without the aux step {statistics.median(bare):.3f} "
        f"ms/step, with it {statistics.median(full):.3f} ms/step (in turns)")


def main(argv):
  import torch
  if not torch.cuda.is_available():
    print("step_profile: no CUDA device", file=sys.stderr)
    return 2
  sys.path.insert(0, ROOT)
  import chip_smoke as cs
  smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True).stdout.strip()
  log(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
  gen = torch.Generator(device=cs.DEVICE).manual_seed(cs.SEED + 1)
  n = 8 * cs.BATCH
  x = cs._counts(torch, gen, n, cs.GENES)
  data = [x, cs._proteins(torch, gen, n),
          cs._onehots(torch, gen, n, cs.N_BATCHES),
          cs._onehots(torch, gen, n, cs.CELL_TYPES), None, None]
  if set(argv or ALL) & set(PHASE11):  # mosaic RNA and peaks
    data[4], data[5] = x.clone(), cs._atac(torch, gen, n)
    cs._mosaic(torch, gen, data[4], data[5])
  for name in argv or ALL:
    with cs._Env(cs.BF16_MODES[SCVI[name][1]] if name in SCVI else {}):
      profile(torch, cs, name, data)
  os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
  with open(os.path.join(ROOT, "chiprun_out", "step_profile.txt"), "w") as f:
    f.write("\n".join(_LINES) + "\n")
  return 0


if __name__ == "__main__":
  sys.exit(main(sys.argv[1:]))
