"""The port's fused ZINB/NB likelihood op (``sisua_tpu_torch.ops.zinb``)
against ``sisua_tpu.ops.zinb_pallas``.

On CPU both sides run their kernel's plain version: the JAX package's
``_rowsum_ref`` and its analytic custom-VJP backward (as
``tests/test_ops.py`` runs them), the port's ``_rowsum_ref`` and
``_zinb_grads_elem`` + ``_unbroadcast`` inside the autograd Function. The
CUDA kernels themselves run only on the card
(``tests/test_torch_port_cuda.py``).

Tolerances: forward rtol 1e-4 (the row-sum order bound of test_ops.py);
gradients rtol 2e-4 / atol 1e-5 (test_ops.py's exhaustive-branch bound).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sisua_tpu.dist as JD
import sisua_tpu_torch.dist as TD
from sisua_tpu.ops import zinb_pallas as jz
from sisua_tpu_torch.models import objective as tobj
from sisua_tpu_torch.ops import _build
from sisua_tpu_torch.ops import zinb as tz
from torch_port_threads import _one_thread  # noqa: F401


FWD = dict(rtol=1e-4)
GRAD = dict(rtol=2e-4, atol=1e-5)


def _operands(seed, B=8, D=24, constrained=False, per_gene=(False,) * 3):
  """x with exact zeros; θ straddling the floor and the 1e6 switch when
  constrained; each parameter (B, D) or a per-gene (1, D) row."""
  rng = np.random.default_rng(seed)
  x = rng.poisson(2, (B, D)).astype(np.float32)
  x[:, :8] = 0.0
  rows = [1 if pg else B for pg in per_gene]
  if constrained:
    cr = rng.gamma(2, 2, (rows[0], D)).astype(np.float32)
    cr[:, -4:] = [1e-9, 0.5, 2e6, 8e6]
  else:
    cr = rng.normal(0, 2, (rows[0], D)).astype(np.float32)
    cr[:, -2:] = [16.0, -17.0]  # outside the ±15 clip
  lg = rng.normal(0, 2, (rows[1], D)).astype(np.float32)
  gt = rng.normal(0, 2, (rows[2], D)).astype(np.float32)
  ct = rng.normal(0, 1, (B,)).astype(np.float32)
  return x, cr, lg, gt, ct


def _port_value_and_grads(x, cr, lg, gt, ct, constrained):
  params = [torch.tensor(a, requires_grad=True) for a in (cr, lg, gt)]
  out = tz._ZinbRowsum.apply(torch.tensor(x), *params, constrained)
  (out * torch.tensor(ct)).sum().backward()
  return out.detach().numpy(), [p.grad.numpy() for p in params]


def _jax_value_and_grads(x, cr, lg, gt, ct, constrained, fn=None):
  fn = fn or (lambda c, l, g: jz._zinb_rowsum(jnp.asarray(x), c, l, g,
                                              constrained))
  val = fn(jnp.asarray(cr), jnp.asarray(lg), jnp.asarray(gt))
  grads = jax.grad(lambda c, l, g: jnp.vdot(fn(c, l, g), jnp.asarray(ct)),
                   argnums=(0, 1, 2))(jnp.asarray(cr), jnp.asarray(lg),
                                      jnp.asarray(gt))
  return np.asarray(val), [np.asarray(g) for g in grads]


LAYOUTS = {"BD": (False, False, False), "gene_theta": (True, False, False),
           "gene_theta_gate": (True, False, True),
           "all_gene": (True, True, True)}


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("constrained", [False, True],
                         ids=["logtheta", "theta"])
def test_rowsum_value_and_grads_match_jax(constrained, layout):
  """Exhaustive branches (zeros, θ floor, both sides of θ = 1e6, the ±15
  clip) in (B, D) and per-gene layouts: value and all three gradients,
  against both the JAX custom VJP and autodiff of the JAX math."""
  ops = _operands(3, constrained=constrained, per_gene=LAYOUTS[layout])
  val, grads = _port_value_and_grads(*ops, constrained)
  assert [g.shape for g in grads] == [a.shape for a in ops[1:4]]
  jval, jgrads = _jax_value_and_grads(*ops, constrained)
  np.testing.assert_allclose(val, jval, **FWD)
  x = jnp.asarray(ops[0])
  _, agrads = _jax_value_and_grads(
      *ops, constrained,
      fn=lambda c, l, g: jz._rowsum_ref(x, c, l, g, constrained))
  for name, a, b, c in zip(("theta", "logits", "gate"), grads, jgrads,
                           agrads):
    np.testing.assert_allclose(a, b, **GRAD, err_msg=f"{name} vs custom VJP")
    np.testing.assert_allclose(a, c, **GRAD, err_msg=f"{name} vs autodiff")


@pytest.mark.parametrize("constrained", [False, True],
                         ids=["logtheta", "theta"])
def test_per_gene_equals_broadcast(constrained):
  """A per-gene (D,) operand gives the same value as its (B, D) broadcast,
  and its gradient is the row-sum of the broadcast gradient
  (test_ops.py:293)."""
  x, cr, lg, gt, ct = _operands(11, B=16, constrained=constrained,
                                per_gene=(True, False, False))
  row = torch.tensor(cr[0], requires_grad=True)
  full = torch.tensor(np.broadcast_to(cr, x.shape).copy(),
                      requires_grad=True)
  tx, tl, tg, tc = (torch.tensor(a) for a in (x, lg, gt, ct))
  a = tz.zinb_log_prob_rowsum(tx, row, tl, tg, constrained)
  b = tz.zinb_log_prob_rowsum(tx, full, tl, tg, constrained)
  np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                             rtol=1e-5)
  (a * tc).sum().backward()
  (b * tc).sum().backward()
  assert row.grad.shape == (x.shape[1],)
  np.testing.assert_allclose(row.grad.numpy(), full.grad.sum(0).numpy(),
                             **GRAD)
  # scalar θ through the NB wrapper equals its full broadcast
  s = tz.nb_log_prob_rowsum(tx, 1.3, tl, constrained=True)
  f = tz.nb_log_prob_rowsum(tx, torch.full_like(tx, 1.3), tl,
                            constrained=True)
  np.testing.assert_allclose(s.numpy(), f.numpy(), rtol=1e-5)


def test_public_wrappers_match_jax():
  """zinb / nb / zinbd / nbd row-sums, including the −1e30 NB gate and
  the mean/dispersion remap, against the JAX package's public functions."""
  x, cr, lg, gt, _ = _operands(5, B=16, D=30)
  rng = np.random.default_rng(6)
  mu = rng.gamma(2.0, 2.0, x.shape).astype(np.float32)
  th = rng.gamma(3.0, 1.0, x.shape).astype(np.float32)
  t = lambda a: torch.tensor(a)  # noqa: E731
  j = jnp.asarray
  pairs = [
      (tz.zinb_log_prob_rowsum(t(x), t(cr), t(lg), t(gt)),
       jz.zinb_log_prob_rowsum(j(x), j(cr), j(lg), j(gt))),
      (tz.nb_log_prob_rowsum(t(x), t(cr), t(lg)),
       jz.nb_log_prob_rowsum(j(x), j(cr), j(lg))),
      (tz.zinbd_log_prob_rowsum(t(x), t(mu), t(th), t(gt)),
       jz.zinbd_log_prob_rowsum(j(x), j(mu), j(th), j(gt))),
      (tz.nbd_log_prob_rowsum(t(x), t(mu), t(th)),
       jz.nbd_log_prob_rowsum(j(x), j(mu), j(th)))]
  for i, (a, b) in enumerate(pairs):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), **FWD,
                               err_msg=f"wrapper {i}")


def test_disp_remap_matches_distribution_math():
  """NB(μ, θ) == NB(total_count=θ, logits=log μ − log θ) (test_ops.py:250),
  port remap against the JAX distribution."""
  rng = np.random.default_rng(4)
  x = rng.poisson(3.0, (16, 24)).astype(np.float32)
  mu = rng.gamma(2.0, 2.0, (16, 24)).astype(np.float32)
  theta = rng.gamma(3.0, 1.0, (16, 24)).astype(np.float32)
  gate = rng.normal(0, 1, (16, 24)).astype(np.float32)
  ref = JD.Independent(JD.ZeroInflated(
      count_distribution=JD.NegativeBinomialDisp(loc=jnp.asarray(mu),
                                                 disp=jnp.asarray(theta)),
      gate_logits=jnp.asarray(gate)), 1).log_prob(jnp.asarray(x))
  tt = [torch.tensor(a) for a in (x, mu, theta, gate)]
  got = tz._rowsum_ref(tt[0], tt[2], tz._disp_to_logits(tt[1], tt[2]),
                       tt[3], constrained=True)
  np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5,
                             atol=2e-4)


def test_extreme_params_finite_and_not_floored():
  """Tiny θ stays finite, huge θ reaches the Poisson limit
  (test_ops.py:32); the −1e30 NB gate does not floor the zero-count
  log-prob or damp its gradient (test_ops.py:233)."""
  from scipy import stats
  x = torch.tensor([[1.0], [7.0], [0.0], [100.0]])
  mu = torch.full((4, 1), 2.0)
  k = tz.nbd_log_prob_rowsum(x, mu, torch.full((4, 1), 1e-8))
  assert torch.isfinite(k).all()
  k = tz.nbd_log_prob_rowsum(x, mu, torch.full((4, 1), 1e8))
  np.testing.assert_allclose(k.numpy(),
                             stats.poisson.logpmf(x.numpy().ravel(), 2.0),
                             rtol=1e-3)
  x0 = torch.zeros((8, 4))
  mu = torch.full((8, 4), 1000.0, requires_grad=True)
  th = torch.full((8, 4), 10.0)
  got = tz.nbd_log_prob_rowsum(x0, mu, th)
  ref = jz.nbd_log_prob_rowsum(jnp.zeros((8, 4)), jnp.full((8, 4), 1000.0),
                               jnp.full((8, 4), 10.0))
  np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                             rtol=1e-5)
  assert float(got[0].detach()) < -180.0  # a floored gate gave ~-160
  got.sum().backward()
  assert mu.grad.abs().min() > 1e-3  # gradients not damped


def test_extreme_grid_matches_jax():
  """θ ∈ {1e-8, 1e7}, logits ±30, x ∈ {0, 1e6}, every combination, value
  and gradients against the JAX custom VJP."""
  grid = np.array(np.meshgrid([1e-8, 1e7], [-30.0, 30.0], [0.0, 1e6],
                              [-3.0, 3.0])).reshape(4, -1).astype(np.float32)
  th, lg, x, gt = (np.tile(a, (4, 1)) for a in grid)
  ct = np.linspace(-1, 1, 4).astype(np.float32)
  val, grads = _port_value_and_grads(x, th, lg, gt, ct, True)
  jval, jgrads = _jax_value_and_grads(x, th, lg, gt, ct, True)
  assert np.isfinite(val).all()
  np.testing.assert_allclose(val, jval, **FWD)
  for a, b in zip(grads, jgrads):
    np.testing.assert_allclose(a, b, **GRAD)


@pytest.mark.parametrize("per_gene", [False, True], ids=["BD", "per_gene"])
@pytest.mark.parametrize("constrained", [False, True],
                         ids=["logtheta", "theta"])
def test_gradcheck_float64(constrained, per_gene):
  """The Function's analytic backward against finite differences of its
  forward, in float64, away from the clip and switch kinks."""
  x, cr, lg, gt, _ = _operands(8, B=4, D=6, constrained=False,
                               per_gene=(per_gene, False, False))
  cr = np.abs(cr) + 0.2 if constrained else np.clip(cr, -3, 3)
  args = [torch.tensor(a.astype(np.float64), requires_grad=True)
          for a in (cr, lg, gt)]
  tx = torch.tensor(x.astype(np.float64))
  assert torch.autograd.gradcheck(
      lambda c, l, g: tz._ZinbRowsum.apply(tx, c, l, g, constrained), args)


def test_cpu_uses_plain_version_and_cuda_path_raises():
  """A CPU tensor takes the plain version and leaves the launch counters
  alone; the kernel path refuses non-CUDA tensors instead of falling
  back."""
  x, cr, lg, gt, _ = _operands(2)
  tt = [torch.tensor(a) for a in (x, cr, lg, gt)]
  tz.reset_launches()
  tz.zinb_log_prob_rowsum(*tt)
  assert tz.launches == {"zinb_rowsum_fwd": 0, "zinb_rowsum_bwd": 0}
  assert not tz.kernels_available(tt[0])
  with pytest.raises(ValueError, match="CUDA tensors"):
    tz._fwd_launch(*tt, False)
  with pytest.raises(ValueError, match="CUDA tensors"):
    tz._bwd_launch(*tt, torch.ones(8), False, (True, True, True))
  meta = [t.to("meta") for t in tt]
  with pytest.raises(ValueError, match="CUDA tensors"):
    tz.zinb_log_prob_rowsum(*meta)


def test_build_command_targets_hopper(tmp_path):
  """The kernels build with nvcc for sm_90a into the git-ignored build/
  directory, under a name keyed by the sources, with FMA contraction on
  (the kernels pass the card's tolerances with it) and the ptxas report:
  one compile per source (zinb.cu and probe.cu), then one link."""
  compiles, link = _build.nvcc_commands(tmp_path / "lib.so")
  assert [c[-1].rsplit("/", 1)[-1] for c in compiles] == ["zinb.cu",
                                                          "probe.cu"]
  for cmd in compiles:
    assert cmd[-1].startswith(str(_build._CSRC))
    assert "arch=compute_90a,code=sm_90a" in cmd and "-c" in cmd
    assert "--fmad=false" not in cmd and "-v" in cmd
  assert "arch=compute_90a,code=sm_90a" in link and "-shared" in link
  assert link[link.index("-o") + 1] == str(tmp_path / "lib.so")
  path = _build.library_path()
  assert path.parent.parent.name == "build"
  assert path.name.startswith("libsisua_kernels_") and path.suffix == ".so"
  assert path == _build.library_path()  # stable for unchanged sources


def _dists(rng, B=16, D=30):
  """One ZINB per NB kind, built as the decode paths build them."""
  log_mu = rng.normal(0, 1, (B, D)).astype(np.float32)
  log_th = rng.normal(0, 0.5, (B, D)).astype(np.float32)
  log_th[0, :2] = [18.0, -18.0]
  th_row = np.exp(rng.normal(0, 0.5, (1, D))).astype(np.float32)
  gt = rng.normal(0, 1, (B, D)).astype(np.float32)
  out = {}
  for kind in ("logits", "disp", "displog", "loglog"):
    def make(M, a, b, kind=kind):
      if kind == "logits":
        return M.NegativeBinomial(total_count=b(np.exp(log_th)),
                                  logits=b(log_mu))
      if kind == "disp":
        return M.NegativeBinomialDisp(loc=b(np.exp(log_mu)),
                                      disp=b(np.exp(log_th)))
      if kind == "displog":
        return M.NegativeBinomialDispLog(log_loc=b(log_mu), disp=b(th_row))
      return M.NegativeBinomialLog(log_loc=b(log_mu), log_disp=b(log_th))
    out[kind] = tuple(
        M.Independent(M.ZeroInflated(make(M, None, b), b(gt)), 1)
        for M, b in ((TD, torch.tensor), (JD, jnp.asarray)))
  return out


@pytest.mark.parametrize("kind", ["logits", "disp", "displog", "loglog"])
def test_objective_routes_each_nb_kind(kind, monkeypatch):
  """With SISUA_TPU_FUSED_LIKELIHOOD=on the objective maps each NB kind
  onto the fused op's operands (per-gene θ stays a (1, D) row; the 'loglog'
  route passes log θ clipped once, constrained=False) and matches the JAX
  distribution math; 'off' takes the port's distribution math."""
  rng = np.random.default_rng(13)
  x = rng.poisson(2, (16, 30)).astype(np.float32)
  tdist, jdist = _dists(rng)[kind]
  ref = np.asarray(jdist.log_prob(jnp.asarray(x)))
  calls = {}
  real = tz.zinb_log_prob_rowsum

  def spy(x_, r_, logits_, gate_, constrained=False):
    calls.update(r=r_, logits=logits_, constrained=constrained)
    return real(x_, r_, logits_, gate_, constrained)

  monkeypatch.setattr(tz, "zinb_log_prob_rowsum", spy)
  for mode in ("on", "off"):
    monkeypatch.setenv("SISUA_TPU_FUSED_LIKELIHOOD", mode)
    calls.clear()
    got = tobj._fast_log_prob(tdist, torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4,
                               err_msg=f"{kind} {mode}")
    assert bool(calls) == (mode == "on")
  monkeypatch.setenv("SISUA_TPU_FUSED_LIKELIHOOD", "on")
  tobj._fast_log_prob(tdist, torch.tensor(x))
  assert calls["constrained"] is (kind != "loglog")
  if kind == "displog":
    assert tuple(calls["r"].shape) == (1, 30)
  if kind == "loglog":
    assert float(calls["r"].max()) == 15.0
    np.testing.assert_allclose(
        calls["logits"].numpy(),
        tdist.base.count_distribution.log_loc.numpy() - calls["r"].numpy(),
        rtol=1e-6)


def test_routing_modes(monkeypatch):
  """'on'/'off' keep the JAX meaning; 'auto' routes exactly CUDA tensors;
  MC-shaped parameters always take the distribution math."""
  cpu = torch.zeros(2, 3)
  assert tobj.route_fused_likelihood(cpu, "on")
  assert not tobj.route_fused_likelihood(cpu, "off")
  assert not tobj.route_fused_likelihood(cpu, "auto")
  monkeypatch.setenv("SISUA_TPU_FUSED_LIKELIHOOD", "on")
  monkeypatch.setattr(tz, "zinb_log_prob_rowsum",
                      lambda *a, **k: pytest.fail("MC params routed"))
  rng = np.random.default_rng(5)
  x = torch.tensor(rng.poisson(2, (16, 30)).astype(np.float32))
  r = torch.tensor(np.exp(rng.normal(0, 1, (3, 16, 30))).astype(np.float32))
  d = TD.Independent(TD.ZeroInflated(
      TD.NegativeBinomial(r, torch.zeros(3, 16, 30)),
      torch.zeros(3, 16, 30)), 1)
  assert tuple(tobj._fast_log_prob(d, x).shape) == (3, 16)


def test_row_strides_read_head_slices_in_place():
  """The 'zinb'/'nb' heads chunk one (B, k·D) output: each (B, D) slice is
  read through its row stride k·D, a (1, D) row with stride 0; column-
  strided or overlapping layouts and a non-contiguous x are refused."""
  x = torch.zeros(4, 5)
  head = torch.zeros(4, 15)
  theta, logits, gate = torch.chunk(head, 3, dim=-1)
  assert tz._row_strides(x, (theta, logits, gate)) == (4, 5, [15, 15, 15])
  assert tz._row_strides(x, (theta, logits, torch.zeros(1, 5))) \
      == (4, 5, [15, 15, 0])
  assert tz._row_strides(x[:1], (theta[:1],) * 3) == (1, 5, [5, 5, 5])
  with pytest.raises(ValueError, match="contiguous rows"):
    tz._row_strides(x, (torch.zeros(5, 4).t(), logits, gate))
  with pytest.raises(ValueError, match="overlap"):
    tz._row_strides(x, (torch.zeros(1, 5).expand(4, 5), logits, gate))
  with pytest.raises(ValueError, match="contiguous x"):
    tz._row_strides(head[:, :5], (theta, logits, gate))
  with pytest.raises(ValueError, match="per-gene"):
    tz._row_strides(x, (torch.zeros(2, 5), logits, gate))


def _head_views(b, d, k=3):
  """x and the k column chunks of one (b, k·d) head output, as the 'zinb'
  (k = 3) and 'nb' (k = 2) heads pass them to the kernels."""
  return torch.zeros(b, d), torch.chunk(torch.zeros(b, k * d), k, dim=-1)


def _plan_for(x, params, n_sm=132):
  b, d, lds = tz._row_strides(x, params)
  return tz._launch_plan(b, d, lds, [t.data_ptr() for t in (x, *params)],
                         n_sm)


def test_launch_plan_copy_width_follows_alignment():
  """SISUA's RNA head views at D = 33,000 (column offsets of 132,000 bytes)
  get 16-byte copies; the protein head's at D = 10 (offsets of 40 and 80
  bytes, row stride 30 floats), a ragged width, an odd row stride and an
  address off 16 bytes get 4-byte copies. A (1, D) row (stride 0) keeps
  the vector path."""
  x, views = _head_views(2, 33_000)
  assert _plan_for(x, views).vec
  assert _plan_for(x, (views[0], torch.zeros(1, 33_000), views[2])).vec
  x, views = _head_views(2, 10)
  assert views[1].data_ptr() % 16 == 8
  assert not _plan_for(x, views).vec
  x, nb = _head_views(4, 10, k=2)
  assert not _plan_for(x, (nb[0], nb[1], torch.zeros(1, 10))).vec
  x, views = _head_views(3, 1001)
  assert not _plan_for(x, views).vec
  wide = torch.zeros(3, 1001)[:, :1000]  # row stride 1001: rows misaligned
  x = torch.zeros(3, 1000)
  assert not _plan_for(x, (wide, x, x)).vec
  flat = torch.zeros(3 * 1000 + 1)
  off = flat[1:].view(3, 1000)  # 4 bytes past an aligned start
  assert not _plan_for(x, (x, off, x)).vec


@pytest.mark.parametrize("b,d", [(4096, 33_000), (65_536, 33_000),
                                 (512, 33_000), (512, 10), (130, 1001),
                                 (4096, 2048), (1, 1), (65_536, 10),
                                 (3, 3_000_000)])
def test_launch_plan_within_cuda_limits(b, d):
  """Grids within CUDA's limits (x < 2^31, y ≤ 65,535), every row and
  128-column tile covered exactly once, forward chunks whole multiples of
  the block's 8 warp tiles, and the backward's per-gene scratch bounded
  (3 · chunks · D floats ≤ 64 MiB at the batch sizes users train with)."""
  for n_sm in (132, 114):
    p = tz._launch_plan(b, d, [d, 0, d], [0, 0, 0, 0], n_sm)
    tiles = -(-d // tz._TILE)
    assert p.fwd_tiles % tz._WARPS == 0
    assert p.fwd_chunks * p.fwd_tiles >= tiles
    assert (p.fwd_chunks - 1) * p.fwd_tiles < tiles
    assert 1 <= p.fwd_chunks <= tz._MAX_GRID_Y and b < 2 ** 31
    assert p.bwd_chunks * p.bwd_rows >= b > (p.bwd_chunks - 1) * p.bwd_rows
    assert 1 <= p.bwd_chunks <= tz._MAX_GRID_Y
    assert p.bwd_rows >= tz._BWD_MIN_ROWS or p.bwd_chunks == 1
    assert 3 * p.bwd_chunks * d * 4 <= 64 * 2 ** 20
    # the forward splits a row only while the batch leaves the card short
    assert p.fwd_chunks == 1 or b * (p.fwd_chunks - 1) < \
        tz._BLOCKS_PER_SM * n_sm


@pytest.mark.parametrize("per_gene", [(False,) * 3, (True, False, False),
                                      (True, True, True)],
                         ids=["BD", "gene_theta", "all_gene"])
def test_launches_pass_the_plan_and_its_scratch(per_gene, monkeypatch):
  """Both wrappers hand the C entry points the plan's copy width, chunks
  and rows, and allocate exactly the scratch those chunks index: (B,
  chunks) forward partials when a row is split, (3, chunks, D) backward
  partials when a per-gene gradient is needed. Run on CPU tensors with the
  card's calls replaced by recorders."""
  b, d = 512, 33_000
  x, cr, lg, gt, ct = _operands(12, B=b, D=d, per_gene=per_gene)
  tt = [torch.tensor(a) for a in (x, cr, lg, gt, ct)]
  made, calls = {}, []

  def scratch(shape, dev):
    t = torch.empty(shape, device=dev, dtype=torch.float32)
    made[t.data_ptr()] = tuple(shape)
    return t

  monkeypatch.setattr(tz, "_check_operands", tz._row_strides)
  monkeypatch.setattr(tz, "_sm_count", lambda dev: 132)
  monkeypatch.setattr(tz, "_scratch", scratch)
  monkeypatch.setattr(tz, "_launch",
                      lambda dev, name, fn, *args: calls.append(args))
  monkeypatch.setattr(_build, "load", lambda: types.SimpleNamespace(
      sisua_zinb_rowsum_fwd=None, sisua_zinb_rowsum_bwd=None))
  tz.reset_launches()
  tz._fwd_launch(*tt[:4], False)
  tz._bwd_launch(*tt, False, (True, True, True))
  assert tz.launches == {"zinb_rowsum_fwd": 1, "zinb_rowsum_bwd": 1}
  _, _, lds = tz._row_strides(tt[0], tt[1:4])
  plan = _plan_for(tt[0], tt[1:4])
  fwd, bwd = calls
  # one member, member strides 0: the (B, D) launch
  assert fwd[6:] == (1, b, d, 0, 0, 0, 0, *lds, int(plan.vec),
                     plan.fwd_tiles, plan.fwd_chunks, 0)
  assert plan.fwd_chunks == 5 and plan.vec
  assert made[fwd[5]] == (b, plan.fwd_chunks)
  assert bwd[9:] == (1, b, d, 0, 0, 0, 0, *lds, int(plan.vec),
                     plan.bwd_rows, plan.bwd_chunks, 0)
  if any(per_gene):
    assert made[bwd[8]] == (3, plan.bwd_chunks, d)
  else:
    assert bwd[8] is None
  assert [made[p] for p in bwd[5:8]] == [(1 if pg else b, d)
                                         for pg in per_gene]
