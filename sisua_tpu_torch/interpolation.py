"""KL warm-up / annealing schedules (port of ``sisua_tpu/interpolation.py``).

A schedule maps the train-step counter to a coefficient (β, the KL
weight). PyTorch runs the loop on the host, so the step is a Python int and
the schedule is evaluated with ``math`` into a float each step.
"""

from __future__ import annotations

import dataclasses
import math

__all__ = ["Interpolation", "const", "linear", "exp", "cosine", "cyclical",
           "get_interpolation"]


@dataclasses.dataclass(frozen=True)
class Interpolation:
  """Schedule: vmin → vmax over [delay_in, delay_in + norm] steps."""

  kind: str = "const"
  vmin: float = 0.0
  vmax: float = 1.0
  norm: float = 1.0          # number of steps for the ramp
  delay_in: float = 0.0      # steps to wait before ramping
  cyclical: bool = False

  def __call__(self, step) -> float:
    t = (float(step) - self.delay_in) / self.norm
    if self.cyclical:
      # hold vmin through the delay instead of wrapping into the ramp
      t = 0.0 if t < 0.0 else t % 1.0
    t = min(max(t, 0.0), 1.0)
    if self.kind == "const":
      a = 1.0
    elif self.kind == "linear":
      a = t
    elif self.kind == "exp":
      a = (math.exp(t * 5.0) - 1.0) / (math.exp(5.0) - 1.0)
    elif self.kind == "expIn":
      a = 1.0 - math.exp(-t * 5.0)
    elif self.kind == "cosine":
      a = 0.5 * (1.0 - math.cos(math.pi * t))
    elif self.kind == "sigmoid":
      a = (0.0 if t <= 0.0 else 1.0 if t >= 1.0
           else 1.0 / (1.0 + math.exp(-12.0 * (t - 0.5))))
    else:
      raise ValueError(f"unknown interpolation kind: {self.kind}")
    return self.vmin + (self.vmax - self.vmin) * a


def const(vmax: float = 1.0) -> Interpolation:
  return Interpolation("const", vmax, vmax)


def linear(vmin: float = 0.0, vmax: float = 1.0, norm: float = 1.0,
           delay_in: float = 0.0, cyclical: bool = False) -> Interpolation:
  return Interpolation("linear", vmin, vmax, norm, delay_in, cyclical)


def exp(vmin: float = 0.0, vmax: float = 1.0, norm: float = 1.0,
        delay_in: float = 0.0, cyclical: bool = False) -> Interpolation:
  return Interpolation("exp", vmin, vmax, norm, delay_in, cyclical)


def cosine(vmin: float = 0.0, vmax: float = 1.0, norm: float = 1.0,
           delay_in: float = 0.0, cyclical: bool = False) -> Interpolation:
  return Interpolation("cosine", vmin, vmax, norm, delay_in, cyclical)


def cyclical(kind: str = "linear", vmin: float = 0.0, vmax: float = 1.0,
             norm: float = 1.0, delay_in: float = 0.0) -> Interpolation:
  return Interpolation(kind, vmin, vmax, norm, delay_in, cyclical=True)


def get_interpolation(x) -> Interpolation:
  """Coerce float | str | dict | Interpolation into a schedule."""
  if isinstance(x, Interpolation):
    return x
  if isinstance(x, (int, float)):
    return const(float(x))
  if isinstance(x, str):
    return Interpolation(kind=x)
  if isinstance(x, dict):
    return Interpolation(**x)
  raise TypeError(f"Cannot parse Interpolation from {x!r}")
