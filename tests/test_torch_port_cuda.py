"""The port's CUDA kernels on the card, against their plain PyTorch
versions. Each test needs a CUDA card and skips without one (the kernels
have no CPU mode). Imports no JAX, so on a machine without it run:

    python -m pytest --noconftest -q tests/test_torch_port_cuda.py

Tolerances: forward rtol 1e-4 (row-sum order); gradients rtol 2e-4 /
atol 1e-5, as tests/test_ops.py holds the TPU kernels. A per-gene (1, D)
gradient is a sum over the B rows, summed in another order than the plain
version's: its atol adds 1e-6 (about 8 float32 ulps) of Σ_rows |term|.
The sparse-count cases, whose rows may hold one or a few elements, add
the same 1e-6 per element to the forward (``_compare``'s ``elem_ulps``).
"""

import numpy as np
import pytest
import torch

from sisua_tpu_torch.ops import _build
from sisua_tpu_torch.ops import zinb as tz

pytestmark = pytest.mark.cuda

FWD = dict(rtol=1e-4)
GRAD = dict(rtol=2e-4, atol=1e-5)
SUM_ULPS = 1e-6
LAYOUTS = {"BD": (False, False, False), "gene_theta": (True, False, False),
           "gene_theta_gate": (True, False, True),
           "all_gene": (True, True, True)}


@pytest.fixture
def dev():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card: the kernels have no CPU mode")
  return torch.device("cuda")


def _operands(dev, seed, B, D, constrained, per_gene):
  rng = np.random.default_rng(seed)
  x = rng.poisson(2, (B, D)).astype(np.float32)
  x[:, :8] = 0.0
  rows = [1 if pg else B for pg in per_gene]
  if constrained:  # the θ floor and both sides of the 1e6 switch
    cr = rng.gamma(2, 2, (rows[0], D)).astype(np.float32)
    cr[:, -4:] = [1e-9, 0.5, 2e6, 8e6][-D:]
  else:  # outside the ±15 clip
    cr = rng.normal(0, 2, (rows[0], D)).astype(np.float32)
    cr[:, -2:] = [16.0, -17.0][-D:]
  lg = rng.normal(0, 2, (rows[1], D)).astype(np.float32)
  gt = rng.normal(0, 2, (rows[2], D)).astype(np.float32)
  ct = rng.normal(0, 1, (B,)).astype(np.float32)
  return [torch.tensor(a, device=dev) for a in (x, cr, lg, gt, ct)]


def _compare(ops, constrained, need=(True, True, True), elem_ulps=False):
  """Kernels against plain versions. ``elem_ulps`` adds to the forward an
  atol of SUM_ULPS per element of each row's Σ (|element| + 1): a zero
  count's log-prob is a difference of O(1) terms, so a row of a few such
  elements (D = 1, 10) is near 0 and carries ~1e-7 absolute rounding in
  any float32 implementation, the plain version's included."""
  x, cr, lg, gt, ct = ops
  out = tz._fwd_launch(x, cr, lg, gt, constrained)
  grads = tz._bwd_launch(x, cr, lg, gt, ct, constrained, need)
  torch.cuda.synchronize()
  ref = tz._rowsum_ref(x, cr, lg, gt, constrained)
  o, r = out.cpu().numpy(), ref.cpu().numpy()
  atol = 0.0
  if elem_ulps:
    elem = tz._zinb_elem(x, cr, lg, gt, constrained)
    atol = SUM_ULPS * (elem.abs() + 1.0).sum(-1).cpu().numpy()
  bad = ~(np.abs(o - r) <= atol + FWD["rtol"] * np.abs(r))
  assert not bad.any(), (f"{bad.sum()} of {bad.size} row sums off, worst "
                         f"|Δ| {np.abs(o - r)[bad].max():.3e}")
  refs = tz._grads_ref(x, cr, lg, gt, ct, constrained, need)
  terms = tz._zinb_grads_elem(x, cr, lg, gt, constrained)
  for a, b, t in zip(grads, refs, terms):
    if b is None:
      assert a is None
      continue
    assert a.shape == b.shape
    atol = GRAD["atol"]
    if b.shape[0] == 1 < x.shape[0]:  # per-gene: a sum over the rows
      atol = atol + SUM_ULPS * (ct[:, None] * t).abs().sum(0).cpu().numpy()
    a, b = a.cpu().numpy(), b.cpu().numpy()
    bad = ~(np.abs(a - b) <= atol + GRAD["rtol"] * np.abs(b))
    assert not bad.any(), (f"{bad.sum()} of {bad.size} gradients off, "
                           f"worst |Δ| {np.abs(a - b)[bad].max():.3e}")
  return grads


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("constrained", [False, True],
                         ids=["logtheta", "theta"])
def test_kernels_match_plain_ragged(dev, constrained, layout):
  """130 × 1001: every row and column edge is masked by the kernels."""
  tz.reset_launches()
  _compare(_operands(dev, 21, 130, 1001, constrained, LAYOUTS[layout]),
           constrained)
  assert tz.launches == {"zinb_rowsum_fwd": 1, "zinb_rowsum_bwd": 1}


def test_extreme_grid(dev):
  """θ ∈ {1e-8, 1e7}, logits ±30, x ∈ {0, 1e6}, every combination."""
  grid = torch.cartesian_prod(torch.tensor([1e-8, 1e7]),
                              torch.tensor([-30.0, 30.0]),
                              torch.tensor([0.0, 1e6]),
                              torch.tensor([-3.0, 3.0])).T
  th, lg, x, gt = (v.repeat(4, 1).to(dev).contiguous() for v in grid)
  _compare([x, th, lg, gt, torch.linspace(-1, 1, 4, device=dev)], True)


def test_nb_gate_row_writes_no_gate_gradient(dev):
  """The −1e30 per-gene gate of the NB heads: exact values, and a field
  whose input needs no gradient is not computed into memory."""
  x, cr, lg, _, ct = _operands(dev, 3, 64, 700, False, (False,) * 3)
  gate = torch.full((1, 700), tz._NB_GATE, device=dev)
  grads = _compare([x, cr, lg, gate, ct], False, need=(True, True, False))
  assert grads[2] is None
  cr.requires_grad_(True)
  out = tz.nb_log_prob_rowsum(x, cr, lg)
  out.sum().backward()
  assert torch.isfinite(cr.grad).all()


def test_backward_is_bitwise_deterministic(dev):
  ops = _operands(dev, 22, 512, 2048, False, (True, False, False))
  a = tz._bwd_launch(*ops, False, (True, True, True))
  b = tz._bwd_launch(*ops, False, (True, True, True))
  assert all(torch.equal(u, v) for u, v in zip(a, b))


def test_forward_is_bitwise_deterministic(dev):
  """Rows split into column chunks are summed in a fixed order."""
  ops = _sparse_operands(dev, 23, 512, 33_000, "7pct", False,
                         (False,) * 3)
  plan = _plan(ops)
  assert plan.fwd_chunks > 1 and plan.vec
  a = tz._fwd_launch(*ops[:4], False)
  assert all(torch.equal(a, tz._fwd_launch(*ops[:4], False))
             for _ in range(3))


# count patterns of the sparse cases: share of nonzero elements, or a rule
PATTERNS = ("7pct", "0.5pct", "zero_rows", "full_rows", "one_per_32")


def _sparse_counts(rng, B, D, pattern):
  """Counts of single-cell sparsity: ~7% or ~0.5% nonzero; every third row
  all zero (the rest 7%); every third row all nonzero; exactly one nonzero
  in each run of 32 columns, at a random place."""
  x = rng.poisson(3.0, (B, D)).astype(np.float32) + 1.0
  if pattern in ("7pct", "0.5pct", "zero_rows", "full_rows"):
    share = 0.005 if pattern == "0.5pct" else 0.07
    x *= rng.random((B, D)) < share
    if pattern == "zero_rows":
      x[::3] = 0.0
    elif pattern == "full_rows":
      x[::3] = rng.poisson(3.0, x[::3].shape) + 1.0
  else:
    keep = np.zeros((B, -(-D // 32) * 32), bool)
    pos = rng.integers(0, 32, (B, keep.shape[1] // 32))
    keep.reshape(B, -1, 32)[np.arange(B)[:, None],
                            np.arange(pos.shape[1]), pos] = True
    x *= keep[:, :D]
  return x


def _sparse_operands(dev, seed, B, D, pattern, constrained, per_gene):
  ops = _operands(dev, seed, B, D, constrained, per_gene)
  x = _sparse_counts(np.random.default_rng(seed + 1000), B, D, pattern)
  return [torch.tensor(x, device=dev)] + ops[1:]


def _plan(ops):
  b, d, lds = tz._row_strides(ops[0], ops[1:4])
  return tz._launch_plan(b, d, lds, [t.data_ptr() for t in ops[:4]],
                         tz._sm_count(ops[0].device))


@pytest.mark.parametrize("width", [1, 10, 1001, 33_001, 33_000])
@pytest.mark.parametrize("pattern", PATTERNS)
def test_sparse_counts_match_plain(dev, pattern, width):
  """Single-cell sparsity through the compacted count path, at widths
  that are and are not a multiple of 4 or of a 128-column tile: the
  16-byte copy path (D = 33,000) and the 4-byte one (the rest)."""
  rows = 64 if width > 10_000 else 130
  ops = _sparse_operands(dev, 40 + width, rows, width, pattern, False,
                         (False,) * 3)
  assert _plan(ops).vec == (width % 4 == 0)
  _compare(ops, False, elem_ulps=True)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("width", [1001, 4096])
def test_sparse_per_gene_layouts_match_plain(dev, layout, width):
  """Per-gene (1, D) operands with sparse counts: per-gene gradients are
  chunk sums over rows; 512 rows make several chunks."""
  _compare(_sparse_operands(dev, 50, 512, width, "7pct", True,
                            LAYOUTS[layout]), True, elem_ulps=True)


@pytest.mark.parametrize("width,vec", [(10, False), (1001, False),
                                       (33_000, True)])
@pytest.mark.parametrize("posterior", ["zinb", "nb"])
def test_head_views_match_plain(dev, posterior, width, vec):
  """The heads' column chunks of one (B, k·D) output, read in place:
  SISUA's (B, 3·10) protein output and a (B, 3·1001) one have rows that
  are not 16-byte aligned and take 4-byte copies; the RNA head's
  (B, 3·33,000) takes 16-byte copies."""
  rng = np.random.default_rng(60 + width)
  rows = 96
  x = torch.tensor(_sparse_counts(rng, rows, width, "7pct"), device=dev)
  head = torch.tensor(rng.normal(0, 2, (rows, 3 * width)).astype(np.float32),
                      device=dev)
  th, lg, gt = torch.chunk(head, 3, dim=-1)
  th = torch.exp(torch.clamp(th, -15.0, 15.0))
  th = torch.chunk(torch.cat([th, lg, gt], -1), 3, -1)[0]  # a view again
  need = (True, True, True)
  if posterior == "nb":
    gt = torch.full((1, width), tz._NB_GATE, device=dev)
    need = (True, True, False)
  ct = torch.tensor(rng.normal(0, 1, rows).astype(np.float32), device=dev)
  ops = [x, th, lg, gt, ct]
  assert not lg.is_contiguous() and _plan(ops).vec == vec
  grads = _compare(ops, True, need, elem_ulps=True)
  assert (grads[2] is None) == (posterior == "nb")


# ------------------------------------------------------------- bf16 modes
BF16_RTOL = 7.9e-3  # 1 bf16 ulp: kernel and plain round the same f32 value


def _compare_bf16(ops, constrained, need=(True, True, True),
                  elem_ulps=False):
  """A bf16 case against the plain version: forward as ``_compare``;
  a (B, D) gradient comes back in its primal's dtype, bf16-valued when the
  writes are bf16, within 1 bf16 ulp of the plain version's; per-gene
  gradients float32 at ``_compare``'s tolerances. Run twice for the same
  bits. Returns the kernels' gradients."""
  x, cr, lg, gt, ct = ops
  out = tz._fwd_launch(x, cr, lg, gt, constrained)
  grads = tz._bwd_launch(x, cr, lg, gt, ct, constrained, need)
  torch.cuda.synchronize()
  ref = tz._rowsum_ref(x, cr, lg, gt, constrained)
  o, r = out.cpu().numpy(), ref.cpu().numpy()
  atol = 0.0
  if elem_ulps:
    elem = tz._zinb_elem(x, *(tz._widen(t) for t in (cr, lg, gt)),
                         constrained)
    atol = SUM_ULPS * (elem.abs() + 1.0).sum(-1).cpu().numpy()
  assert (np.abs(o - r) <= atol + FWD["rtol"] * np.abs(r)).all()
  refs = tz._grads_ref(x, cr, lg, gt, ct, constrained, need)
  terms = tz._zinb_grads_elem(x, *(tz._widen(t) for t in (cr, lg, gt)),
                              constrained)
  bf16_writes = tz._write_dtype((cr, lg, gt)) == torch.bfloat16
  for a, b, t, p in zip(grads, refs, terms, (cr, lg, gt)):
    if b is None:
      assert a is None
      continue
    assert a.shape == b.shape and a.dtype == b.dtype == p.dtype
    if b.shape[0] == 1 < x.shape[0]:  # per-gene: an f32 sum over the rows
      atol = GRAD["atol"] + SUM_ULPS * (ct[:, None] * t).abs().sum(0)
      bad = (a - b).abs() > atol + GRAD["rtol"] * b.abs()
    else:
      if bf16_writes:
        assert torch.equal(a, a.to(torch.bfloat16).to(a.dtype))
      a, b = a.float(), b.float()
      bad = (a - b).abs() > GRAD["atol"] + BF16_RTOL * b.abs()
    assert not bad.any(), f"{int(bad.sum())} gradients off"
  assert torch.equal(out, tz._fwd_launch(x, cr, lg, gt, constrained))
  twice = tz._bwd_launch(x, cr, lg, gt, ct, constrained, need)
  assert all(u is None or torch.equal(u, v) for u, v in zip(grads, twice))
  return grads


def _as_bf16(ops, per_gene):
  """The (B, D) parameters of ``ops`` as bf16; x, per-gene rows and the
  cotangent stay float32."""
  x, cr, lg, gt, ct = ops
  params = [p if pg else p.to(torch.bfloat16)
            for p, pg in zip((cr, lg, gt), per_gene)]
  return [x, *params, ct]


@pytest.mark.parametrize("shape", [(130, 1001), (256, 4096)],
                         ids=["ragged_ordinary_loads", "aligned_8byte"])
@pytest.mark.parametrize("layout", ["BD", "gene_theta", "gene_theta_gate"])
@pytest.mark.parametrize("constrained", [False, True],
                         ids=["logtheta", "theta"])
def test_bf16_operands_match_plain(dev, constrained, layout, shape):
  """bf16 (B, D) operands beside float32 per-gene rows: 8-byte cp.async
  copies where rows are 8-byte aligned, ordinary 2-byte loads where the
  width is odd; bf16 gradients."""
  per_gene = LAYOUTS[layout]
  ops = _as_bf16(_sparse_operands(dev, 60, *shape, "7pct", constrained,
                                  per_gene), per_gene)
  b, d, lds = tz._row_strides(ops[0], ops[1:4])
  vec = tz._launch_plan(b, d, lds, [t.data_ptr() for t in ops[:4]],
                        tz._sm_count(dev),
                        [t.element_size() for t in ops[:4]]).vec
  assert vec == (shape[1] % 4 == 0)
  _compare_bf16(ops, constrained, elem_ulps=True)


def test_bf16_protein_head_views(dev):
  """The 10-protein NB head in bf16: three 20-byte column chunks of one
  (B, 30) bf16 matrix, rows 4-byte aligned only (ordinary loads), with the
  −1e30 float32 gate row."""
  rng = np.random.default_rng(61)
  x = torch.tensor(rng.poisson(8.0, (512, 10)).astype(np.float32),
                   device=dev)
  head = torch.tensor(rng.normal(0, 1, (512, 30)).astype(np.float32),
                      device=dev).to(torch.bfloat16)
  r, lg, _ = torch.chunk(head, 3, dim=-1)
  r = torch.exp(r.float()).to(torch.bfloat16)
  gate = torch.full((1, 10), tz._NB_GATE, device=dev)
  ct = torch.tensor(rng.normal(0, 1, 512).astype(np.float32), device=dev)
  assert lg.stride() == (30, 1) and lg.data_ptr() % 8 == 4
  _compare_bf16([x, r.contiguous(), lg, gate, ct], True,
                need=(True, True, False), elem_ulps=True)


def test_bf16_writes_for_f32_operands(dev, monkeypatch):
  """``SISUA_TPU_BWD_WRITES=bf16`` with float32 operands: the (B, D)
  fields are written bf16 and widened, the per-gene one stays an f32
  sum."""
  monkeypatch.setenv("SISUA_TPU_BWD_WRITES", "bf16")
  ops = _sparse_operands(dev, 62, 512, 4096, "7pct", False,
                         (True, False, False))
  grads = _compare_bf16(ops, False)
  assert all(g.dtype == torch.float32 for g in grads)


def test_bf16_autograd_through_the_objective(dev, monkeypatch):
  """SCVI's 'full' head under ``SISUA_TPU_FWD_OPERANDS=bf16`` at B = 512:
  the operands reach the kernels as bf16, the leaves get float32
  gradients within bf16 rounding of the float32 route's."""
  from sisua_tpu_torch import dist as TD
  from sisua_tpu_torch.models import objective as tobj
  rng = np.random.default_rng(63)
  x = torch.tensor(rng.poisson(1.0, (512, 2048)).astype(np.float32),
                   device=dev)
  leaves = [torch.tensor(rng.normal(m, 1, (512, 2048)).astype(np.float32),
                         device=dev) for m in (0.3, 0.5, -1.0)]
  out = {}
  for mode in ("f32", "bf16"):
    monkeypatch.setenv("SISUA_TPU_FWD_OPERANDS", mode)
    ts = [t.clone().requires_grad_() for t in leaves]
    d = TD.Independent(TD.ZeroInflated(
        count_distribution=TD.NegativeBinomialLog(log_loc=ts[0],
                                                  log_disp=ts[1]),
        gate_logits=ts[2]), 1)
    tz.reset_launches()
    lp = tobj._fast_log_prob(d, x)
    lp.sum().backward()
    assert tz.launches == {"zinb_rowsum_fwd": 1, "zinb_rowsum_bwd": 1}
    out[mode] = (lp.detach(), [t.grad for t in ts])
  lp32, g32 = out["f32"]
  lp16, g16 = out["bf16"]
  assert not torch.equal(lp32, lp16)
  assert ((lp16 - lp32).abs() <= 1e-2 * lp32.abs()).all()
  for a, b in zip(g16, g32):
    assert a.dtype == torch.float32
    assert float((a - b).norm()) <= 2e-2 * float(b.norm())


def test_wrappers_raise_instead_of_falling_back(dev):
  x, cr, lg, gt, _ = _operands(dev, 4, 8, 16, False, (False,) * 3)
  with pytest.raises(TypeError, match="float32"):
    tz.zinb_log_prob_rowsum(x.double(), cr.double(), lg.double(),
                            gt.double())
  with pytest.raises(ValueError, match="contiguous"):
    tz._fwd_launch(x, cr.t().contiguous().t(), lg, gt, False)
  with pytest.raises(ValueError, match="per-gene"):
    tz._fwd_launch(x, cr[:2], lg, gt, False)
  with pytest.raises(ValueError, match="CUDA tensors"):
    tz._fwd_launch(x, cr.cpu(), lg, gt, False)
  assert _build.library_path().with_suffix(".log").is_file()


def test_scvi_fit_goes_through_kernels(dev):
  """Every train step launches each kernel once; evaluate the forward."""
  from sisua_tpu_torch.models import SCVI, RVmeta
  rng = np.random.default_rng(5)
  x = rng.poisson(1.0, (256, 300)).astype(np.float32)
  m = SCVI(RVmeta(300, "zinbd", name="rna"), device="cuda",
           latents=RVmeta(4, "diag", name="latents"))
  tz.reset_launches()
  m.fit(x, epochs=2, batch_size=32, device_cache=True)
  assert tz.launches == {"zinb_rowsum_fwd": 16, "zinb_rowsum_bwd": 16}
  assert np.isfinite(m.history["loss"]).all()
  ev = m.evaluate(x[:100], batch_size=64)
  assert np.isfinite(list(ev.values())).all()
  assert tz.launches == {"zinb_rowsum_fwd": 18, "zinb_rowsum_bwd": 16}


def _zinb_head_operands(dev, seed, B, D, nb_gate):
  """The 'zinb'/'nb' heads' operands: θ = exp(clip(raw, ±15)) decoded in
  torch (constrained=True), here from raw ~ N(0, 6) so that θ lies on both
  sides of the kernel's θ > 1e6 switch, and (B, D) logits; the 'zinb' gate
  is (B, D), the 'nb' gate the −1e30 per-gene row."""
  rng = np.random.default_rng(seed)
  x = rng.poisson(np.exp(2.0 + rng.normal(0, 1, (B, D)))).astype(np.float32)
  x[:, 0] = 0.0
  th = np.exp(np.clip(rng.normal(0, 6, (B, D)), -15, 15)).astype(np.float32)
  lg = rng.normal(0, 2, (B, D)).astype(np.float32)
  gt = (np.full((1, D), tz._NB_GATE, np.float32) if nb_gate
        else rng.normal(0, 2, (B, D)).astype(np.float32))
  ct = rng.normal(0, 1, (B,)).astype(np.float32)
  return [torch.tensor(a, device=dev) for a in (x, th, lg, gt, ct)]


@pytest.mark.parametrize("shape", [(512, 3000), (130, 1001)],
                         ids=["512x3000", "ragged"])
def test_zinb_logits_layout(dev, shape):
  """SISUA's 'zinb' RNA head: three (B, D) operands, constrained=True,
  with θ past 1e6 in about one element in a hundred."""
  ops = _zinb_head_operands(dev, 31, *shape, nb_gate=False)
  assert float((ops[1] > 1e6).float().mean()) > 0.005
  _compare(ops, True)


@pytest.mark.parametrize("rows", [512, 37])
def test_adt_nb_layout(dev, rows):
  """SISUA's 'nb' protein head: 10 columns, (B, D) θ and logits, the
  −1e30 gate row, no gate gradient."""
  grads = _compare(_zinb_head_operands(dev, 32, rows, 10, nb_gate=True),
                   True, need=(True, True, False))
  assert grads[2] is None


def test_sisua_fit_goes_through_kernels(dev):
  """Each train step launches each kernel twice (RNA and protein heads);
  validation and evaluate run the forward twice per batch."""
  from sisua_tpu_torch.models import SISUA, RVmeta
  rng = np.random.default_rng(6)
  x = rng.poisson(1.0, (320, 300)).astype(np.float32)
  y = rng.poisson(5.0, (320, 10)).astype(np.float32)
  m = SISUA([RVmeta(300, "zinb", name="rna"), RVmeta(10, "nb", name="adt")],
            device="cuda", alpha=10.0, latents=RVmeta(4, "diag", name="z"))
  tz.reset_launches()
  m.fit([x[:256], y[:256]], valid=[x[256:], y[256:]], epochs=2,
        batch_size=32, labels_percent=0.1, device_cache=True)
  # 2 epochs × 8 steps; 2 validations × 2 batches of the 64 held-out cells
  assert tz.launches == {"zinb_rowsum_fwd": 2 * (16 + 4),
                         "zinb_rowsum_bwd": 2 * 16}
  assert np.isfinite(m.history["loss"]).all()
  assert len(m.history["val_loss"]) == 2
  ev = m.evaluate([x[256:], y[256:]], batch_size=64)
  assert np.isfinite(list(ev.values())).all()
  assert tz.launches["zinb_rowsum_fwd"] == 2 * (16 + 4 + 1)


@pytest.mark.parametrize("model", ["VAE", "MISA", "DeepCountAutoencoder"])
def test_models_fit_with_valid_on_card(dev, model):
  """VAE, MISA ('zinb' + 'nbd' → 'mixnb': only the RNA head reaches the
  kernels) and DCA train through ``fit(train, valid=…)`` on the card."""
  from sisua_tpu_torch import models as T
  rng = np.random.default_rng(7)
  x = rng.poisson(1.0, (160, 300)).astype(np.float32)
  y = rng.poisson(5.0, (160, 10)).astype(np.float32)
  outs = [T.RVmeta(300, "zinb", name="rna")]
  if model == "MISA":
    outs.append(T.RVmeta(10, "nbd", name="adt"))
  data = [x, y][:len(outs)]
  m = getattr(T, model)(outs if len(outs) > 1 else outs[0], device="cuda")
  tz.reset_launches()
  m.fit([a[:128] for a in data], valid=[a[128:] for a in data], epochs=2,
        batch_size=32, device_cache=True)
  # 2 epochs × 4 steps; 2 validations of one 32-row batch
  assert tz.launches == {"zinb_rowsum_fwd": 8 + 2, "zinb_rowsum_bwd": 8}
  assert np.isfinite(m.history["loss"]).all()
  assert np.isfinite(m.history["val_loss"]).all()


@pytest.mark.parametrize("posterior", ["zinb", "nb"])
def test_head_slices_read_in_place(dev, posterior):
  """The heads' chunks of one (B, k·D) output go to the kernels without a
  copy; values and the gradient of the head output match the same fused op
  on CPU copies (its plain version)."""
  from sisua_tpu_torch.rv import RVmeta
  rng = np.random.default_rng(33)
  B, D = 96, 333
  rv = RVmeta(D, posterior)
  raw = rng.normal(0, 3, (B, rv.n_params)).astype(np.float32)
  counts = rng.poisson(2.0, (B, D)).astype(np.float32)
  out = {}
  tz.reset_launches()
  for where in (dev, torch.device("cpu")):
    r = torch.tensor(raw, device=where, requires_grad=True)
    x = torch.tensor(counts, device=where)
    base = rv.create_distribution(r).base
    if posterior == "zinb":
      nb = base.count_distribution
      assert not nb.logits.is_contiguous()
      lp = tz.zinb_log_prob_rowsum(x, nb.total_count, nb.logits,
                                   base.gate_logits, constrained=True)
    else:
      assert not base.logits.is_contiguous()
      lp = tz.nb_log_prob_rowsum(x, base.total_count, base.logits,
                                 constrained=True)
    lp.sum().backward()
    out[where.type] = (lp.detach().cpu().numpy(), r.grad.cpu().numpy())
  assert tz.launches == {"zinb_rowsum_fwd": 1, "zinb_rowsum_bwd": 1}
  np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], **FWD)
  np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], **GRAD)


def test_checkpoint_round_trip_serves_on_card(dev, tmp_path):
  """save_weights → load_model on the card: weights and history come back,
  evaluate equals the trained model's at the same noise with the forward
  kernel twice per batch (SISUA's two heads), and the serving half runs on
  the card through the distribution math (no kernel launch) but
  ``compute_llk``, whose draws take the forward kernel as its member axis
  once per head and batch."""
  from sisua_tpu_torch.models import SISUA, RVmeta, load_model
  rng = np.random.default_rng(8)
  x = rng.poisson(1.0, (192, 300)).astype(np.float32)
  y = rng.poisson(5.0, (192, 10)).astype(np.float32)
  m = SISUA([RVmeta(300, "zinb", name="rna"), RVmeta(10, "nb", name="adt")],
            device="cuda", latents=RVmeta(4, "diag", name="latents"))
  m.fit([x[:128], y[:128]], epochs=2, batch_size=32, device_cache=True)
  m.save_weights(str(tmp_path))
  m2 = load_model(str(tmp_path), device="cuda")
  assert m2.device == torch.device("cuda", torch.cuda.current_device())
  sd = m.module.state_dict()
  assert all(torch.equal(v, sd[k]) for k, v in m2.module.state_dict().items())
  assert m2.history == m.history
  held = [x[128:], y[128:]]
  evs = []
  tz.reset_launches()
  for model in (m, m2):
    model.generator.manual_seed(3)
    evs.append(model.evaluate(held, batch_size=32))
  assert tz.launches == {"zinb_rowsum_fwd": 2 * 2 * 2, "zinb_rowsum_bwd": 0}
  for k, v in evs[0].items():
    np.testing.assert_allclose(evs[1][k], v, rtol=1e-6, err_msg=k)
  tz.reset_launches()
  means = []
  for data, kw in ((x, {}), (torch.tensor(x, device=dev), {}),
                   (x, {"fetch_dtype": "bfloat16"})):
    m2.generator.manual_seed(4)
    means.append(m2.predict_mean(data, sample_shape=(3,), batch_size=32,
                                 **kw))
  (xm, zm), (rx, rz), (bx, _) = means
  assert [a.shape for a in xm + zm] == [(192, 300), (192, 10), (192, 4)]
  for a, b in zip(xm + zm, rx + rz):  # int16 host upload = resident data
    np.testing.assert_array_equal(a, b)
  for a, b in zip(bx, xm):
    np.testing.assert_allclose(a, b, rtol=1e-2, atol=1e-30)
  pX, qZ = m2.predict(x, batch_size=32, device_cache=True)
  assert pX[0].mean().device.type == "cpu"
  np.testing.assert_allclose(qZ.mean().numpy(), zm[0], rtol=1e-6,
                             atol=1e-7)
  assert tz.launches == {"zinb_rowsum_fwd": 0, "zinb_rowsum_bwd": 0}
  llk = m2.compute_llk(x, {"t": [x, y]}, sample_shape=(2,), batch_size=32)
  assert np.isfinite(list(llk.values())).all()
  assert tz.launches == {"zinb_rowsum_fwd": 2 * 192 // 32,
                         "zinb_rowsum_bwd": 0}
  tz.reset_launches()
  assert np.isfinite(m2.marginal_log_prob(x[:40], 8, batch_size=16)).all()
  assert tz.launches == {"zinb_rowsum_fwd": 0, "zinb_rowsum_bwd": 0}


# --------------------------------------------- the zoo: SCALE … LDVAE
ZOO = {"SCALE": 1, "SCALAR": 2, "FVAE": 1, "SemiFVAE": 2, "LDVAE": 1}


def _zoo_model(name, genes, dev):
  from sisua_tpu_torch import models as T
  rna = T.RVmeta(genes, "nbd" if name == "LDVAE" else "zinb", name="rna")
  outs = [rna, T.RVmeta(10, "nb", name="adt")]
  kw = {"SCALE": dict(n_components=10), "SCALAR": dict(n_components=10),
        "FVAE": dict(gamma=6.0)}.get(name, {})
  if name in ("SCALAR", "SemiFVAE"):
    return getattr(T, name)(outs, device=dev, alpha=10.0, **kw)
  return getattr(T, name)(rna, device=dev, **kw)


def _zoo_batch(m, rows, seed, dev):
  """A train batch for ``m`` (mixed mask, library stats) and reparameter-
  ization noise for each of its latents: a standard-normal draw, or
  (component indices, component noise) for a mixture latent."""
  from sisua_tpu_torch.data import get_library_size
  g = torch.Generator(device=dev).manual_seed(seed)
  lam = torch.exp(-1.0 + torch.randn((rows, m.outputs[0].dim), generator=g,
                                     device=dev))
  xs = [torch.poisson(lam, generator=g)]
  xs += [torch.poisson(torch.full((rows, rv.dim), 20.0, device=dev),
                       generator=g) for rv in m.outputs[1:]]
  batch = {"inputs": xs, "mask": (torch.rand(rows, generator=g, device=dev)
                                  < 0.5).float()}
  if m.uses_library:
    batch["library"] = torch.cat(get_library_size(xs[0]), 1)
  noise = []
  for rv in m.latents:
    k = rv.kw.get("n_components")
    if rv.posterior == "mixgaus":
      noise.append((torch.randint(0, k, (rows,), generator=g, device=dev),
                    torch.randn((rows, k, rv.dim), generator=g, device=dev)))
    else:
      noise.append(torch.randn((rows, rv.dim), generator=g, device=dev))
  return batch, noise


def _route(m, state, batch, noise, mode):
  """Loss and parameter gradients of one train-mode step under one route
  ('auto' takes the kernels on the card, 'off' the distribution math)."""
  import os
  os.environ["SISUA_TPU_FUSED_LIKELIHOOD"] = mode
  try:
    m.module.load_state_dict(state)
    m.generator.manual_seed(11)
    m.module.zero_grad(set_to_none=True)
    loss, _, out = m._loss(batch, True, 1.0, noise=noise)
    loss.backward()
  finally:
    os.environ.pop("SISUA_TPU_FUSED_LIKELIHOOD", None)
  return float(loss.detach()), {k: p.grad.clone()
                       for k, p in m.module.named_parameters()}, out


@pytest.mark.parametrize("name", list(ZOO))
def test_zoo_step_kernel_route_matches_plain(dev, name):
  """One train step's loss (rtol 1e-4) and every parameter gradient
  (max|Δg| ≤ 1e-3·(max|g| of it + 1e-3·max|g| overall), as chip_smoke.py
  phase 7) on the kernel route against the plain route, at the same
  weights, dropout and noise; each head launches each kernel once. Then
  one optimizer step through ``_train_step`` on the kernel route."""
  m = _zoo_model(name, 1000, dev)
  batch, noise = _zoo_batch(m, 128, 12, dev)
  state = {k: v.clone() for k, v in m.module.state_dict().items()}
  tz.reset_launches()
  lk, gk, _ = _route(m, state, batch, noise, "auto")
  heads = ZOO[name]
  assert tz.launches == {"zinb_rowsum_fwd": heads, "zinb_rowsum_bwd": heads}
  lp, gp, _ = _route(m, state, batch, noise, "off")
  assert tz.launches["zinb_rowsum_fwd"] == heads
  assert abs(lk - lp) <= 1e-4 * abs(lp)
  top = max(float(g.abs().max()) for g in gp.values())
  for k, g in gp.items():
    assert float((gk[k] - g).abs().max()) \
        <= 1e-3 * (float(g.abs().max()) + 1e-3 * top), k
  if m.aux is not None:
    assert all(p.grad is None for p in m.aux.parameters())
  m.optimizer = torch.optim.Adam(m.module.parameters(), lr=1e-3)
  if m.aux is not None:
    m.aux_optimizer = m._make_aux_optimizer()
  tz.reset_launches()
  metrics = m._train_step(batch)
  assert tz.launches == {"zinb_rowsum_fwd": heads, "zinb_rowsum_bwd": heads}
  assert all(torch.isfinite(v).all() for v in metrics.values())
  assert ("disc_loss" in metrics) == (m.aux is not None)


def test_ldvae_per_gene_theta_gradient_at_full_width(dev):
  """LDVAE 'nbd' with per-gene θ at 512 × 33,000: the gradient of
  ``px_r_single`` is a column sum over the 512 rows, taken by the kernels
  in another order than the plain route. Per gene it holds to rtol 2e-4
  and atol 1e-5 + SUM_ULPS·Σ_rows |its row terms| (θ·∂ℓ/∂θ and the
  ∂ℓ/∂logits term through logits = log μ − log θ, over B)."""
  m = _zoo_model("LDVAE", 33_000, dev)
  batch, noise = _zoo_batch(m, 512, 13, dev)
  state = {k: v.clone() for k, v in m.module.state_dict().items()}
  tz.reset_launches()
  _, gk, _ = _route(m, state, batch, noise, "auto")
  assert tz.launches == {"zinb_rowsum_fwd": 1, "zinb_rowsum_bwd": 1}
  _, gp, out = _route(m, state, batch, noise, "off")
  nb = out.outputs[0].base
  theta = nb.disp.detach()
  logits = nb.log_loc.detach() - torch.log(theta + 1e-8)
  gate = torch.full_like(theta, tz._NB_GATE)
  d_theta, d_logits, _ = tz._zinb_grads_elem(batch["inputs"][0], theta,
                                             logits, gate, True)
  rows = ((theta * d_theta).abs() + d_logits.abs()).sum(0) / 512
  a, b = gk["px_r_single"], gp["px_r_single"]
  bound = GRAD["atol"] + SUM_ULPS * rows + GRAD["rtol"] * b.abs()
  bad = (a - b).abs() > bound
  assert not bad.any(), (f"{int(bad.sum())} of {b.numel()} genes off, "
                         f"worst |Δ| {float((a - b).abs().max()):.3e}")


# ------------------------ batch conditioning, TotalVI and SCANVI at width
NEW = {"SCVI_batch": 2, "TotalVI": 1, "SCANVI": 1}  # ZINB/NB heads


def _new_model(name, genes, dev):
  """chip_smoke.py phase 10's models: SCVI 'zinbd' at n_batch = 4 with an
  'nb' label head, TotalVI (n_batch = 4, mask_protein), SCANVI over 10
  cell types."""
  from sisua_tpu_torch import models as T
  rna = T.RVmeta(genes, "zinbd", name="rna")
  if name == "SCVI_batch":
    return T.SCVI([rna, T.RVmeta(10, "nb", name="adt")], n_batch=4,
                  alpha=10.0, device=dev)
  if name == "TotalVI":
    return T.TotalVI([rna, T.RVmeta(10, "nbd", name="adt")], n_batch=4,
                     mask_protein=True, device=dev)
  return T.SCANVI([rna, T.RVmeta(10, "onehot", name="celltype")],
                  device=dev)


def _new_batch(m, rows, seed, dev):
  """A train batch for ``m`` (counts, proteins or cell types, the batch
  one-hot, a mixed mask, library stats) and noise for each latent and for
  the forward's second draw (TotalVI's log β, SCANVI's z₂)."""
  from sisua_tpu_torch.data import get_library_size
  g = torch.Generator(device=dev).manual_seed(seed)

  def onehot(k):
    return torch.nn.functional.one_hot(
        torch.randint(0, k, (rows,), generator=g, device=dev), k).float()
  lam = torch.exp(-1.0 + torch.randn((rows, m.outputs[0].dim), generator=g,
                                     device=dev))
  xs = [torch.poisson(lam, generator=g)]
  if type(m).__name__ == "SCANVI":
    xs.append(onehot(m.n_labels))
  else:
    xs += [torch.poisson(torch.full((rows, 10), 20.0, device=dev),
                         generator=g), onehot(m.n_batch)]
  batch = {"inputs": xs, "library": torch.cat(get_library_size(xs[0]), 1),
           "mask": (torch.rand(rows, generator=g, device=dev) < 0.5).float()}
  noise = [torch.randn((rows, rv.dim), generator=g, device=dev)
           for rv in m.latents]
  if type(m).__name__ == "TotalVI":
    noise.append(torch.randn((rows, 10), generator=g, device=dev))
  elif type(m).__name__ == "SCANVI":
    noise.append(torch.randn((m.n_labels, rows, m.latents[0].dim),
                             generator=g, device=dev))
  return batch, noise


@pytest.mark.parametrize("name", list(NEW))
def test_batch_totalvi_scanvi_step_at_full_width(dev, name):
  """One train step at 512 × 33,000 on the kernel route against the plain
  route (loss rtol 1e-4, every gradient within chip_smoke.py phase 7's
  bound): each ZINB/NB head launches each kernel once (SCVI's RNA and
  label heads; TotalVI's and SCANVI's RNA head, their protein mixture and
  cell-type head take plain math). Then one optimizer step through
  ``_train_step``, with the same launches per step."""
  m = _new_model(name, 33_000, dev)
  batch, noise = _new_batch(m, 512, 14, dev)
  state = {k: v.clone() for k, v in m.module.state_dict().items()}
  heads = NEW[name]
  tz.reset_launches()
  lk, gk, _ = _route(m, state, batch, noise, "auto")
  assert tz.launches == {"zinb_rowsum_fwd": heads, "zinb_rowsum_bwd": heads}
  lp, gp, _ = _route(m, state, batch, noise, "off")
  assert tz.launches["zinb_rowsum_fwd"] == heads
  assert abs(lk - lp) <= 1e-4 * abs(lp)
  top = max(float(g.abs().max()) for g in gp.values())
  for k, g in gp.items():
    assert float((gk[k] - g).abs().max()) \
        <= 1e-3 * (float(g.abs().max()) + 1e-3 * top), k
  m.optimizer = torch.optim.Adam(m.module.parameters(), lr=1e-3)
  tz.reset_launches()
  metrics = m._train_step(batch)
  assert tz.launches == {"zinb_rowsum_fwd": heads, "zinb_rowsum_bwd": heads}
  assert all(torch.isfinite(v).all() for v in metrics.values())


# ------------------------------------------ MULTIVI: mosaic rows, gated θ
def test_gated_rows_add_nothing_to_per_gene_theta(dev):
  """MULTIVI's RNA head through the fused op: per-gene θ, logits =
  log μ − log θ, and the output gate multiplying the row sums after the op,
  so the backward gets g = 0 on RNA-less rows. Those rows are all-zero
  counts at log μ = −16.118095 (library clipped to 0, the log-scale
  floor), so their row sums are ~−1e-4, differences of O(1) terms:
  kernels against plain with ``_compare``'s per-element atol; no NaN;
  θ's gradient with the gated rows equals θ's gradient of the ungated rows
  alone (per gene, rtol 2e-4 and atol 1e-5 + SUM_ULPS·Σ_rows |∂ℓ/∂θ
  terms|, the two sums running over other rows in another order)."""
  rng = np.random.default_rng(31)
  B, D = 512, 2048
  x = rng.poisson(1.0, (B, D)).astype(np.float32)
  log_mu = rng.normal(-1.0, 1.5, (B, D)).astype(np.float32)
  gated = np.zeros(B, bool)
  gated[:51] = True
  gated[300:310] = True
  x[gated] = 0.0
  log_mu[gated] = -16.118095
  theta = np.exp(rng.normal(0, 1, (1, D))).astype(np.float32)
  gate = rng.normal(-1, 1, (B, D)).astype(np.float32)
  mask = (~gated).astype(np.float32)
  x, log_mu, theta_t, gate, mask = (torch.tensor(a, device=dev) for a in
                                    (x, log_mu, theta, gate, mask))
  logits = log_mu - torch.log(theta_t + 1e-8)
  g = mask * torch.tensor(rng.normal(0, 1, B).astype(np.float32), device=dev)
  grads = _compare([x, theta_t, logits, gate, g], True, elem_ulps=True)
  assert all(torch.isfinite(t).all() for t in grads)
  assert torch.equal(grads[1][gated], torch.zeros_like(grads[1][gated]))
  assert torch.equal(grads[2][gated], torch.zeros_like(grads[2][gated]))

  def theta_grad(rows):
    th = theta_t.clone().requires_grad_(True)
    lg = log_mu[rows] - torch.log(th + 1e-8)
    lp = tz.zinb_log_prob_rowsum(x[rows], th, lg, gate[rows],
                                 constrained=True)
    (lp * mask[rows]).sum().backward()
    return th.grad
  tz.reset_launches()
  full = theta_grad(slice(None))
  kept = theta_grad(torch.nonzero(mask).squeeze(1))
  assert tz.launches == {"zinb_rowsum_fwd": 2, "zinb_rowsum_bwd": 2}
  assert torch.isfinite(full).all()
  terms = tz._zinb_grads_elem(x, theta_t, logits, gate, True)
  rows = (terms[0].abs() + terms[1].abs() / theta_t).sum(0)
  bound = GRAD["atol"] + SUM_ULPS * rows + GRAD["rtol"] * kept.abs()
  assert bool(((full - kept).abs() <= bound).all())


def test_multivi_step_with_mosaic_rows(dev):
  """One MULTIVI train step at 512 × (2,048 genes + 4,096 peaks), n_batch =
  4, with paired, RNA-only and ATAC-only rows: the kernel route against
  the plain route (loss rtol 1e-4, every gradient within chip_smoke.py
  phase 7's bound), the RNA head launching each kernel once and the
  Bernoulli peaks none; then one optimizer step through ``_train_step``."""
  from sisua_tpu_torch import models as T
  from sisua_tpu_torch.data import get_library_size
  G, R, rows = 2048, 4096, 512
  m = T.MULTIVI([T.RVmeta(G, "zinbd", name="rna"),
                 T.RVmeta(R, "bernoulli", name="atac")], n_batch=4,
                device=dev)
  g = torch.Generator(device=dev).manual_seed(15)
  x = torch.poisson(torch.exp(-1.0 + torch.randn((rows, G), generator=g,
                                                 device=dev)), generator=g)
  a = torch.clamp_max(torch.poisson(torch.full((rows, R), 0.05, device=dev),
                                    generator=g), 4.0)
  x[:51] = 0.0     # ATAC-only
  a[51:102] = 0.0  # RNA-only
  onehot = torch.nn.functional.one_hot(
      torch.randint(0, 4, (rows,), generator=g, device=dev), 4).float()
  batch = {"inputs": [x, a, onehot],
           "library": torch.cat(get_library_size(x), 1),
           "mask": torch.ones(rows, device=dev)}
  noise = [torch.randn((rows, rv.dim), generator=g, device=dev)
           for rv in m.latents]
  state = {k: v.clone() for k, v in m.module.state_dict().items()}
  tz.reset_launches()
  lk, gk, out = _route(m, state, batch, noise, "auto")
  assert tz.launches == {"zinb_rowsum_fwd": 1, "zinb_rowsum_bwd": 1}
  lp, gp, _ = _route(m, state, batch, noise, "off")
  assert tz.launches["zinb_rowsum_fwd"] == 1
  assert abs(lk - lp) <= 1e-4 * abs(lp)
  top = max(float(g.abs().max()) for g in gp.values())
  for k, g in gp.items():
    assert torch.isfinite(gk[k]).all(), k
    assert float((gk[k] - g).abs().max()) \
        <= 1e-3 * (float(g.abs().max()) + 1e-3 * top), k
  m.optimizer = torch.optim.Adam(m.module.parameters(), lr=1e-3)
  tz.reset_launches()
  metrics = m._train_step(batch)
  assert tz.launches == {"zinb_rowsum_fwd": 1, "zinb_rowsum_bwd": 1}
  assert all(torch.isfinite(v).all() for v in metrics.values())
  assert float(metrics["modality_penalty"].detach()) > 0.0


# ------------------------------------------------- AUTOZI and the chunked codec
def _autozi_step_inputs(dev, genes, rows, seed):
  """An AUTOZI ('full' dispersion), a train batch, and noise for z, l and
  δ's two log-gamma draws."""
  from sisua_tpu_torch import models as T
  from sisua_tpu_torch.data import get_library_size
  from sisua_tpu_torch.models.autozi import _draw_log_gamma
  m = T.AUTOZI(T.RVmeta(genes, "zinbd", name="rna"), device=dev,
               n_total_cells=8192)
  g = torch.Generator(device=dev).manual_seed(seed)
  with torch.no_grad():  # δ's posterior off Beta(1, 1)
    m.module.log_alpha_delta.normal_(0.0, 1.0, generator=g)
    m.module.log_beta_delta.normal_(0.0, 1.0, generator=g)
  lam = torch.exp(-1.0 + torch.randn((rows, genes), generator=g, device=dev))
  x = torch.poisson(lam, generator=g)
  batch = {"inputs": [x], "library": torch.cat(get_library_size(x), 1),
           "mask": torch.ones(rows, device=dev)}
  a, b = m.module.delta_posterior()
  with torch.no_grad():
    noise = [torch.randn((rows, rv.dim), generator=g, device=dev)
             for rv in m.latents]
    noise.append((_draw_log_gamma(a, g), _draw_log_gamma(b, g)))
  return m, batch, noise


def test_autozi_step_kernel_route_matches_plain(dev):
  """One AUTOZI train step at 512 × 4,096, the same weights, dropout and
  draws (δ's as a noise entry): the composed (B, D) gate reaches both
  kernels once ('loglog'), loss rtol 1e-4 and every gradient within
  chip_smoke.py phase 7's bound; then one optimizer step."""
  m, batch, noise = _autozi_step_inputs(dev, 4096, 512, 16)
  state = {k: v.clone() for k, v in m.module.state_dict().items()}
  tz.reset_launches()
  lk, gk, out = _route(m, state, batch, noise, "auto")
  assert tz.launches == {"zinb_rowsum_fwd": 1, "zinb_rowsum_bwd": 1}
  assert out.outputs[0].base.gate_logits.shape == (512, 4096)
  lp, gp, _ = _route(m, state, batch, noise, "off")
  assert tz.launches["zinb_rowsum_fwd"] == 1
  assert abs(lk - lp) <= 1e-4 * abs(lp)
  top = max(float(g.abs().max()) for g in gp.values())
  for k, g in gp.items():
    assert torch.isfinite(gk[k]).all(), k
    assert float((gk[k] - g).abs().max()) \
        <= 1e-3 * (float(g.abs().max()) + 1e-3 * top), k
  m.optimizer = torch.optim.Adam(m.module.parameters(), lr=1e-3)
  tz.reset_launches()
  metrics = m._train_step(batch)
  assert tz.launches == {"zinb_rowsum_fwd": 1, "zinb_rowsum_bwd": 1}
  assert all(torch.isfinite(v).all() for v in metrics.values())
  assert "klqp_delta" in metrics


def test_autozi_gate_gradient_reaches_delta(dev):
  """δ's two parameters get their gradient from the backward kernel's
  gate gradient (a column sum over the rows) plus the Beta KL: with the
  KL taken out it is still non-zero, and finite, on the kernel route."""
  m, batch, noise = _autozi_step_inputs(dev, 2048, 256, 17)
  m._extra_loss = lambda out, batch, training: None  # the likelihood only
  state = {k: v.clone() for k, v in m.module.state_dict().items()}
  tz.reset_launches()
  _, gk, _ = _route(m, state, batch, noise, "auto")
  assert tz.launches["zinb_rowsum_bwd"] == 1
  for k in ("log_alpha_delta", "log_beta_delta"):
    assert torch.isfinite(gk[k]).all() and float(gk[k].abs().max()) > 0, k


def test_chunked_leaf_round_trip_on_card(dev, tmp_path):
  """A (16,385 × 16,385) f32 leaf (1.07 GB > 2^30 bytes) on the card goes
  out chunked (two chunks, the second of 16,385 · 16,385 − 2^28 elements)
  and comes back bitwise."""
  from sisua_tpu_torch.train import checkpoint as ckpt
  from sisua_tpu_torch.train import msgpack as mp
  n = 16_385
  w = torch.randn((n, n), generator=torch.Generator(device=dev)
                  .manual_seed(18), device=dev)
  ckpt.save_weights(str(tmp_path), {"Imputation": {"kernel": w}})
  with open(tmp_path / "params.msgpack", "rb") as f:
    head = f.read(256)
  assert b"__msgpack_chunked_array__" in head
  with open(tmp_path / "params.msgpack", "rb") as f:
    back = mp.unpackb(f.read())["Imputation"]["kernel"]
  assert back.shape == (n, n) and back.flags.writeable
  assert torch.equal(torch.from_numpy(back).to(dev), w)


# ------------------------------------- probe kernels and the host data path
PROBE_SHAPES = [(64, 2048), (130, 1001)]  # aligned rows; ragged, 4-byte


@pytest.mark.parametrize("shape", PROBE_SHAPES, ids=["aligned", "ragged"])
@pytest.mark.parametrize("n_fma", [1, 64, 256])
def test_elemwise_probe_kernel(dev, n_fma, shape):
  """Row sums against the plain version: rtol 1e-4 plus 1e-6 of the row's
  Σ|element| (sum order; the kernel fuses each multiply-add). A long
  chain takes a in (0, 1) so it stays finite. Twice: the same bits."""
  from sisua_tpu_torch.ops import probe as P
  x, a, b, c = P.probe_operands(*shape, dev, seed=n_fma)
  if n_fma > 1:
    a = torch.rand(shape, device=dev, generator=torch.Generator(
        device=dev).manual_seed(3))
  got = P.elemwise_probe(x, a, b, c, n_fma)
  ref = P.elemwise_probe_ref(x, a, b, c, n_fma)
  acc = x
  for _ in range(n_fma):
    acc = acc * a + b
  atol = 1e-6 * acc.abs().sum(-1)
  assert torch.all((got - ref).abs() <= atol + 1e-4 * ref.abs())
  assert torch.equal(got, P.elemwise_probe(x, a, b, c, n_fma))


@pytest.mark.parametrize("shape", PROBE_SHAPES, ids=["aligned", "ragged"])
@pytest.mark.parametrize("which", ["lanczos", "stirling", "lgammaf"])
def test_lgamma_probe_kernel(dev, which, shape):
  from sisua_tpu_torch.ops import probe as P
  x, a, b, c = P.probe_operands(*shape, dev, seed=5)
  got = P.lgamma_probe(x, a, b, c, which)
  ref = P.lgamma_probe_ref(x, a, b, c, which)
  atol = 1e-6 * torch.lgamma(x + a + 1.0).abs().sum(-1)
  assert torch.all((got - ref).abs() <= atol + 1e-4 * ref.abs())
  assert torch.equal(got, P.lgamma_probe(x, a, b, c, which))


def test_probes_read_every_operand(dev):
  """A NaN planted in an operand the TPU probe never reads reaches its
  row: the kernels move all 16 bytes of an element."""
  from sisua_tpu_torch.ops import probe as P
  x, a, b, c = P.probe_operands(16, 1000, dev)
  c[3, 999] = float("nan")
  b[9, 0] = float("nan")
  nan = lambda t: torch.isnan(t).nonzero().flatten().tolist()  # noqa: E731
  assert nan(P.elemwise_probe(x, a, b, c, 1)) == [3, 9]
  assert nan(P.lgamma_probe(x, a, b, c, "lanczos")) == [3, 9]


@pytest.mark.parametrize("dtype", [torch.float32, torch.int16,
                                   torch.bfloat16])
def test_densify_on_the_card(dev, dtype):
  """Pinned host triplets densified on the card, in pieces, equal the CPU
  densify; duplicates accumulate (int16 in int16, bf16 in bf16)."""
  import scipy.sparse as sp
  from sisua_tpu_torch.ops import sparse as S
  rng = np.random.default_rng(0)
  m = sp.random(300, 5000, density=0.07, format="csr", random_state=1,
                data_rvs=lambda n: rng.integers(1, 9, n)).astype(np.float32)
  rows = rng.permutation(300)[:256]
  nnz = int(np.diff(m.indptr)[rows].sum())
  vals, cols, rowlen = S.csr_row_triplets(
      m.indptr.astype(np.int64), m.indices.astype(np.int64), m.data, rows,
      nnz + 100, 256, np.float32, np.uint16)
  vals[nnz:nnz + 2] = [1.0, 2.0]  # two adds into (last row, column 0)
  host = [torch.from_numpy(vals).to(dtype), torch.from_numpy(
      cols.view(np.int16)), torch.from_numpy(rowlen)]
  ref = S.densify(*host, 5000, dtype)
  got = S.densify(*(t.pin_memory() for t in host), 5000, dtype, dev,
                  piece=4096)
  assert got.dtype == dtype and torch.equal(got.cpu(), ref)
  assert float(ref[-1, 0]) == float(m[rows[-1], 0]) + 3.0


def test_streaming_and_out_of_core_fits_on_the_card(dev):
  """SCVI at 2,000 genes on the card: streaming with int16 transfers
  trains bitwise like float32 transfers; out of core, the CSR matrix's
  triplet upload trains like its dense rows (rtol 1e-6)."""
  import scipy.sparse as sp
  from sisua_tpu_torch.models import SCVI, RVmeta

  def model():
    return SCVI(RVmeta(2000, "zinbd", name="rna"), device=dev, seed=0,
                latents=RVmeta(8, "diag", name="latents"),
                encoder={"units": [32]}, decoder={"units": [32]})
  x = np.random.default_rng(2).poisson(0.3, (4096, 2000)).astype(np.float32)
  xs = sp.csr_matrix(x)
  runs = {}
  for td in (None, "int16"):
    m = model()
    m.fit(xs, valid=x[:512], epochs=2, batch_size=256, valid_freq=8,
          transfer_dtype=td)
    runs[td] = m.history["loss"]
  assert runs[None] == runs["int16"] and np.isfinite(runs[None]).all()
  budget = 1 << 24  # 256-row chunks: 16, 6 resident
  hists = {}
  for name, data in (("dense", x), ("csr", xs)):
    m = model()
    m.fit(data, epochs=2, batch_size=256, device_cache=True,
          hbm_budget_bytes=budget)
    assert m.trainer._oc_plan["sparse_sources"] == [name == "csr"]
    hists[name] = m.history["loss"]
  np.testing.assert_allclose(hists["csr"], hists["dense"], rtol=1e-6)


# -------------------------------------------------- member-batched launches
def _member_operands(dev, seed, m, B, D, constrained, per_gene, x_shared):
  """M members' operands stacked on a leading axis; a shared x keeps one
  (1, B, D) copy (member stride 0)."""
  sets = [_operands(dev, seed + i, B, D, constrained, per_gene)
          for i in range(m)]
  x, cr, lg, gt, ct = (torch.stack([s[j] for s in sets]) for j in range(5))
  return (x[:1] if x_shared else x), cr, lg, gt, ct


@pytest.mark.parametrize("x_shared", [True, False], ids=["x_shared",
                                                         "x_member"])
@pytest.mark.parametrize("layout", ["BD", "gene_theta", "all_gene"])
@pytest.mark.parametrize("constrained", [False, True],
                         ids=["logtheta", "theta"])
def test_member_batched_kernels_match_plain(dev, constrained, layout,
                                            x_shared):
  """Three members of 130 × 1001 in one launch of each kernel: against the
  plain versions over the member axis, the same bits twice, and each
  member equal bit for bit to its own (B, D) launch."""
  m = 3
  x, cr, lg, gt, ct = _member_operands(dev, 40, m, 130, 1001, constrained,
                                       LAYOUTS[layout], x_shared)
  need = (True, True, True)
  tz.reset_launches()
  out = tz._fwd_launch(x, cr, lg, gt, constrained, members=m)
  grads = tz._bwd_launch(x, cr, lg, gt, ct, constrained, need, members=m)
  torch.cuda.synchronize()
  assert tz.launches == {"zinb_rowsum_fwd": 1, "zinb_rowsum_bwd": 1}
  xm = x.expand(m, *x.shape[1:])
  ref = tz._rowsum_ref(xm, cr, lg, gt, constrained)
  torch.testing.assert_close(out, ref, rtol=FWD["rtol"], atol=0.0)
  refs = tz._grads_ref(xm, cr, lg, gt, ct, constrained, need)
  terms = tz._zinb_grads_elem(xm, cr, lg, gt, constrained)
  for a, b, t in zip(grads, refs, terms):
    assert a.shape == b.shape
    atol = GRAD["atol"]
    if b.shape[1] == 1:  # per-gene: a sum over each member's rows
      atol = atol + SUM_ULPS * (ct[..., None] * t).abs().sum(1, keepdim=True)
      atol = atol.cpu().numpy()
    a_, b_ = a.cpu().numpy(), b.cpu().numpy()
    assert (np.abs(a_ - b_) <= atol + GRAD["rtol"] * np.abs(b_)).all()
  again = tz._fwd_launch(x, cr, lg, gt, constrained, members=m)
  again_g = tz._bwd_launch(x, cr, lg, gt, ct, constrained, need, members=m)
  assert torch.equal(out, again)
  assert all(torch.equal(a, b) for a, b in zip(grads, again_g))
  for i in range(m):
    xi = x[0] if x_shared else x[i]
    assert torch.equal(out[i], tz._fwd_launch(xi, cr[i], lg[i], gt[i],
                                              constrained))
    one = tz._bwd_launch(xi, cr[i], lg[i], gt[i], ct[i], constrained, need)
    assert all(torch.equal(a[i], b) for a, b in zip(grads, one))


def test_vmapped_grad_launches_each_kernel_once(dev):
  """``torch.func.vmap(torch.func.grad(…))`` over 4 members reaches one
  forward and one backward launch, matching a loop of single launches."""
  m, (x, cr, lg, gt, ct) = 4, _member_operands(dev, 50, 4, 256, 2048, False,
                                               LAYOUTS["gene_theta"], True)

  def loss(c, l, g, xx, w):
    return torch.sum(tz.zinb_log_prob_rowsum(xx, c, l, g) * w)
  tz.reset_launches()
  grads = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1, 2)),
                          in_dims=(0, 0, 0, None, 0))(cr, lg, gt, x[0], ct)
  torch.cuda.synchronize()
  assert tz.launches == {"zinb_rowsum_fwd": 1, "zinb_rowsum_bwd": 1}
  for i in range(m):
    one = torch.func.grad(loss, argnums=(0, 1, 2))(cr[i], lg[i], gt[i],
                                                   x[0], ct[i])
    for a, b in zip(grads, one):
      assert torch.equal(a[i], b)


def test_vmap_ensemble_on_the_card(dev):
  """A 3-member SCVI fleet ('zinbd', full dispersion) for 2 epochs: each
  kernel launched once per fleet step, losses finite and falling."""
  from sisua_tpu_torch.models import SCVI
  from sisua_tpu_torch.rv import RVmeta
  from sisua_tpu_torch.train import VmapEnsemble
  rng = np.random.default_rng(3)
  x = rng.poisson(rng.gamma(2.0, 1.0, (1024, 2000))).astype(np.float32)
  ens = VmapEnsemble(lambda s: SCVI(RVmeta(2000, "zinbd", name="rna"),
                                    seed=s, device="cuda"), n_models=3)
  tz.reset_launches()
  ens.fit(x, epochs=2, batch_size=256)
  torch.cuda.synchronize()
  steps = 2 * (1024 // 256)
  assert tz.launches == {"zinb_rowsum_fwd": steps, "zinb_rowsum_bwd": steps}
  loss = ens.history["loss"]
  assert np.isfinite(loss).all() and (loss[-1] < loss[0]).all()


FLEETS = {"FVAE": 1, "AUTOZI": 1}  # ZINB/NB heads


def _fleet(name, dev, genes=2000):
  from sisua_tpu_torch import models as T
  from sisua_tpu_torch.train import VmapEnsemble
  if name == "FVAE":
    make = lambda s: T.FVAE(T.RVmeta(genes, "zinb", name="rna"),  # noqa
                            seed=s, device=dev)
  else:
    make = lambda s: T.AUTOZI(T.RVmeta(genes, "zinbd", name="rna"),  # noqa
                              seed=s, device=dev)
  ens = VmapEnsemble(make, n_models=3)
  ens._stacked = ens._stack_states()
  return ens


def _to(entries, dev):
  return [None if e is None else tuple(t.to(dev) for t in e)
          if isinstance(e, tuple) else e.to(dev) for e in entries]


@pytest.mark.parametrize("name", list(FLEETS))
def test_fleet_step_on_card_matches_cpu_plain_route(dev, name):
  """One 3-member fleet step (FVAE with its discriminator step; AUTOZI
  with δ's pair from each member's α, β) on the card and on the CPU's
  plain route from the same weights, batch and draws: one launch of each
  kernel per head for the fleet; loss and metrics rtol 1e-4; gradients
  within 1e-3 of (each tensor's max|g| + 1e-3 of the largest: the routes'
  bound in chip_smoke.py); parameters after the step within 2·lr. The
  discriminator step then runs from the card's updated state on both:
  its loss rtol 1e-4, its parameters within 2·lr."""
  from sisua_tpu_torch.data import get_library_size
  lr, clip = 1e-3, 100.0
  card, cpu = _fleet(name, dev), _fleet(name, "cpu")
  g = torch.Generator(device=dev).manual_seed(5)
  x = torch.poisson(torch.exp(-1.0 + torch.randn((256, 2000), generator=g,
                                                 device=dev)), generator=g)
  batch = {"inputs": [x], "mask": torch.ones(256, device=dev),
           "library": torch.cat(get_library_size(x), 1)}
  host = {k: ([t.cpu() for t in v] if k == "inputs" else v.cpu())
          for k, v in batch.items()}
  plan = card._draw_plan(batch)
  noise, masks = card._draws(plan)
  aux_draws = None if plan.aux is None else card._aux_draws(plan)
  fns = {}
  for ens, b in ((card, batch), (cpu, host)):
    p = ens._draw_plan(b)
    fns[id(ens)] = (ens._make_step(True, True, p),
                    ens._make_aux_step(True, True, p))
  tz.reset_launches()
  loss, metrics, grads = card._train_step(fns[id(card)][0], batch, noise,
                                          masks, lr, clip)
  torch.cuda.synchronize()
  heads = FLEETS[name]
  assert tz.launches == {"zinb_rowsum_fwd": heads, "zinb_rowsum_bwd": heads}
  closs, cmetrics, cgrads = cpu._train_step(
      fns[id(cpu)][0], host, _to(noise, "cpu"), _to(masks, "cpu"), lr, clip)
  np.testing.assert_allclose(loss.cpu(), closs, rtol=1e-4)
  for k in cmetrics:
    np.testing.assert_allclose(metrics[k].detach().cpu(), cmetrics[k],
                               rtol=1e-4, atol=1e-6, err_msg=k)
  scale = max(float(v.abs().max()) for v in cgrads.values())
  for k, v in cgrads.items():
    bound = float(v.abs().max()) + 1e-3 * scale
    assert float((grads[k].cpu() - v).abs().max()) <= 1e-3 * bound, k
  st, cst = card._stacked, cpu._stacked
  for k, v in cst["params"].items():
    assert float((st["params"][k].cpu() - v).abs().max()) <= 2 * lr + 1e-6
  if aux_draws is not None:
    for group in ("params", "buffers"):
      for k, v in st[group].items():
        cst[group][k].copy_(v.cpu())
    tz.reset_launches()
    disc = card._aux_train_step(fns[id(card)][1], aux_draws, batch)
    cdisc = cpu._aux_train_step(fns[id(cpu)][1], _to(aux_draws, "cpu"), host)
    assert tz.launches == {"zinb_rowsum_fwd": 0, "zinb_rowsum_bwd": 0}
    np.testing.assert_allclose(disc.cpu(), cdisc, rtol=1e-4)
    dlr = card._aux_adam[0]
    for k, v in cst["aux"]["params"].items():
      assert float((st["aux"]["params"][k].cpu() - v).abs().max()) \
          <= 2 * dlr + 1e-7, k


# ------------------------------------------------------------- analysis
def test_knn_mutual_information_card_equals_cpu(dev):
  """The same jittered float32 operands on the card and on the CPU count
  the same neighbours: atol 1e-5 nats, including a padded last chunk
  and query block."""
  from sisua_tpu_torch.ops.knn_mi import knn_mutual_information
  rng = np.random.default_rng(8)
  z = rng.gamma(2.0, 1.0, (600, 2))
  X = rng.poisson(z @ rng.uniform(0.3, 2.0, (2, 21))).astype(np.float32)
  Y = rng.poisson(z @ rng.uniform(0.3, 2.0, (2, 4))).astype(np.float32)
  for kw in (dict(), dict(chunk=4, qblock=256)):
    card = knn_mutual_information(X, Y, device=dev, **kw)
    cpu = knn_mutual_information(X, Y, device="cpu", **kw)
    np.testing.assert_allclose(card, cpu, rtol=0, atol=1e-5)
    assert (card >= 0).all() and card.max() > 0.05


@pytest.mark.parametrize("n_pairs", [5000, 4999])
@pytest.mark.parametrize("mode", ["change", "vanilla"])
def test_de_statistics_on_the_card_equal_numpy(dev, mode, n_pairs):
  """float64 statistics on the card against the JAX package's numpy
  statements on the same draws: rtol 1e-10 (of the pairs' RMS lfc for the
  lfc mean and median, of the two logarithms for the Bayes factor, where
  larger than the value), ``proba_*`` exact; an even ``n_pairs`` takes
  the mean of the two middle values as ``np.median``."""
  from sisua_tpu_torch.models import base
  rng = np.random.default_rng(n_pairs)
  s1 = rng.dirichlet(np.ones(3000), size=400)
  s2 = rng.dirichlet(np.ones(3000), size=300)
  s2[:, :7] = s1[:300, :7]
  i1 = rng.integers(0, 400, n_pairs)
  i2 = rng.integers(0, 300, n_pairs)
  want = base._de_stats_numpy(s1, s2, i1, i2, mode, 0.25)
  got = base._de_stats_torch(torch.tensor(s1, device=dev),
                             torch.tensor(s2, device=dev), i1, i2, mode,
                             0.25)
  for k in want:
    if k.startswith("proba"):
      np.testing.assert_array_equal(got[k], want[k], err_msg=k)
      continue
    # relative to the value, or to the terms it is a difference or a
    # signed sum of where larger (a value near 0 keeps their rounding)
    scale = np.abs(want[k])
    if k in ("lfc_mean", "lfc_median"):
      scale = np.maximum(scale, np.hypot(want["lfc_mean"], want["lfc_std"]))
    if k == "bayes_factor":
      p = want.get("proba_de", want.get("proba_m1"))
      scale = np.maximum(scale, np.abs(np.log(p + 1e-10))
                         + np.abs(np.log1p(1e-10 - p)))
    err = np.abs(got[k] - want[k]) / np.maximum(scale, 1e-300)
    assert err.max() <= 1e-10, (k, err.max())


@pytest.mark.parametrize("shape", [(512, 3300), (511, 3301)])
def test_imputation_medians_on_the_card_equal_numpy(dev, shape):
  from sisua_tpu_torch.analysis import (imputation_mean_score,
                                        imputation_score)
  rng = np.random.default_rng(shape[1])
  org = rng.poisson(2.0, shape).astype(np.float32)
  cor = org.copy()
  cor[::3, :40] = 0.0
  imp = rng.gamma(2.0, 1.0, shape).astype(np.float32)
  t = [torch.tensor(a, device=dev) for a in (org, cor, imp)]
  assert imputation_score(t[0], t[2]) == float(np.median(np.abs(org - imp)))
  mask = (org != cor).any(1)
  want = np.median(np.abs(org[mask] - imp[mask]), axis=1).mean()
  np.testing.assert_allclose(imputation_mean_score(*t), want, rtol=1e-6)


def test_nll_member_axis_one_forward_launch(dev):
  """S = 4 MC draws of a ZINB head score through one launch of the forward
  kernel (x shared at member stride 0), equal to the plain version's
  distribution math."""
  import sisua_tpu_torch.dist as TD
  from sisua_tpu_torch.models.objective import mc_row_log_prob
  g = torch.Generator(device=dev).manual_seed(0)
  S, B, D = 4, 512, 3000
  x = torch.poisson(torch.full((B, D), 1.5, device=dev), generator=g)
  f = lambda *s: torch.randn(s, generator=g, device=dev)  # noqa: E731
  dist = TD.Independent(TD.ZeroInflated(
      TD.NegativeBinomialDispLog(f(S, B, D), torch.exp(f(1, D))),
      f(S, B, D)), 1)
  tz.reset_launches()
  got = mc_row_log_prob(dist, x)
  torch.cuda.synchronize()
  assert tz.launches == {"zinb_rowsum_fwd": 1, "zinb_rowsum_bwd": 0}
  want = dist.log_prob(x)
  np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                             **FWD)


# ------------------------------------------- the posterior hub's estimators
CPU = torch.device("cpu")


def _groups(seed, n=2000, d=8, k=4):
  rng = np.random.default_rng(seed)
  ids = rng.integers(0, k, n)
  return rng.normal(size=(n, d)) + 2.5 * np.eye(k, d)[ids], ids


def test_label_scores_on_the_card_equal_cpu(dev):
  """Contingency tables and silhouette distances on the card: within 1e-9
  of the CPU (float64; the ARI's pair counts in int64, exact)."""
  from sisua_tpu_torch.analysis import estimators as E
  Z, ids = _groups(1)
  pred = np.random.default_rng(2).integers(0, 5, len(ids))
  for name in ("adjusted_rand_score", "normalized_mutual_info_score",
               "mutual_info_score"):
    fn = getattr(E, name)
    card = fn(torch.as_tensor(ids, device=dev),
              torch.as_tensor(pred, device=dev), device=dev)
    assert abs(card - fn(ids, pred, device=CPU)) <= 1e-9, name
  card = E.silhouette_score(torch.as_tensor(Z, device=dev), ids, device=dev)
  assert abs(card - E.silhouette_score(Z, ids, device=CPU)) <= 1e-9
  yt = (Z[:, :3] > 0).astype(int)
  yp = (Z[:, 3:6] > 0).astype(int)
  for avg in ("micro", "macro"):
    assert E.f1_score(torch.as_tensor(yt, device=dev), yp, average=avg,
                      device=dev) == E.f1_score(yt, yp, average=avg,
                                                device=CPU)


def test_mixtures_and_kmeans_on_the_card_equal_cpu(dev):
  """The same host draws give the same partitions (up to relabeling) on
  the card as on the CPU; inertia and lower bound within 1e-9 relative."""
  from sisua_tpu_torch.analysis import estimators as E
  Z, _ = _groups(3)
  for data in (Z, np.random.default_rng(4).normal(size=(1500, 5))):
    zc = torch.as_tensor(data, device=dev)
    km_c = E.KMeans(4, n_init=10, random_state=8, device=dev).fit(zc)
    km = E.KMeans(4, n_init=10, random_state=8, device=CPU).fit(data)
    assert km_c.labels_.device == zc.device
    assert E.adjusted_rand_score(km_c.labels_.cpu(), km.labels_,
                                 device=CPU) == 1.0
    assert abs(km_c.inertia_ / km.inertia_ - 1) <= 1e-9
    for cov in ("full", "diag"):
      gm_c = E.GaussianMixture(4, covariance_type=cov, random_state=8,
                               device=dev)
      gm = E.GaussianMixture(4, covariance_type=cov, random_state=8,
                             device=CPU)
      lc, l0 = gm_c.fit_predict(data), gm.fit_predict(data)
      assert E.adjusted_rand_score(lc.cpu(), l0, device=CPU) == 1.0, cov
      assert abs(gm_c.lower_bound_ / gm.lower_bound_ - 1) <= 1e-9, cov


def test_linear_classifiers_on_the_card_equal_cpu(dev):
  from sisua_tpu_torch.analysis import estimators as E
  Z, ids = _groups(5, n=1200)
  Y = np.stack([ids == 0, Z[:, 5] > 0.3], 1).astype(int)
  svc_c = E.LinearSVC(device=dev).fit(torch.as_tensor(Z, device=dev), Y)
  svc = E.LinearSVC(device=CPU).fit(Z, Y)
  np.testing.assert_allclose(svc_c.coef_.cpu().numpy(), svc.coef_.numpy(),
                             rtol=1e-9, atol=1e-10)
  assert (svc_c.predict(Z).cpu().numpy() == svc.predict(Z).numpy()).all()
  lr_c = E.LogisticRegression(device=dev).fit(
      torch.as_tensor(Z, device=dev), torch.as_tensor(ids, device=dev))
  lr = E.LogisticRegression(device=CPU).fit(Z, ids)
  np.testing.assert_allclose(lr_c.coef_.cpu().numpy(), lr.coef_.numpy(),
                             rtol=1e-8, atol=1e-9)
  assert lr_c.score(Z, ids) == lr.score(Z, ids)


def test_clustering_scores_and_embedding_on_the_card_equal_cpu(dev):
  """``clustering_scores`` on card latents against the CPU within 1e-9,
  and ``ProbabilisticEmbedding`` fitted on the card giving the CPU's bins."""
  from sisua_tpu_torch.analysis import clustering_scores
  from sisua_tpu_torch.label_threshold import ProbabilisticEmbedding
  Z, ids = _groups(6)
  card = clustering_scores(Z, ids)                 # the default: 'cuda'
  cpu = clustering_scores(Z, ids, device=CPU)
  assert list(card) == list(cpu)
  for k in cpu:
    assert abs(card[k] - cpu[k]) <= 1e-9, k
  rng = np.random.default_rng(7)
  pos = rng.random((800, 4)) < 0.4
  X = np.where(pos, rng.poisson(150, (800, 4)),
               rng.poisson(6, (800, 4))).astype(np.float32)
  pe_c = ProbabilisticEmbedding().fit(X)           # the default: 'cuda'
  pe = ProbabilisticEmbedding(device=CPU).fit(X)
  assert pe_c._models[0][1].means_.device.type == "cuda"
  np.testing.assert_array_equal(pe_c.predict(X), pe.predict(X))


def test_experimenter_runs_a_config_on_the_card(dev, tmp_path):
  """A tiny ``run_config`` of SISUA on 'cuda': the model lives on the
  card, every training step and the posterior's log-likelihoods launch
  the ZINB kernels, the scores are finite and the errors table is empty."""
  from sisua_tpu_torch.train.experimenter import SisuaExperimenter
  exp = SisuaExperimenter(save_path=str(tmp_path), device="cuda")
  cfg = exp.load_config({"model.name": "sisua", "dataset.name": "synthetic200",
                         "train.epochs": 2, "train.valid_freq": 0,
                         "variables.latents.event_shape": 4})
  tz.reset_launches()
  scores = exp.run_config(cfg)
  assert tz.launches["zinb_rowsum_fwd"] > 0
  assert tz.launches["zinb_rowsum_bwd"] > 0
  assert scores and all(np.isfinite(v) for v in scores.values())
  assert exp.scoreboard.read_errors() == []
  (_, model), = exp.get_models("model.name=sisua")
  assert model.device.type == "cuda"
  assert len(exp.scoreboard.read_scores("scores_synthetic200")) == 1


# ------------------------------------------------------ the data analyzer
def _analyzer_pair():
  from sisua_tpu_torch.data import generate_synthetic
  s = generate_synthetic(n_cells=600, n_genes=80, n_proteins=8,
                         n_celltypes=4, seed=5218)
  return s.copy(), s.copy()


def test_analyzer_pca_on_the_card_equals_cpu(dev, monkeypatch):
  """PCA (full, randomized) and IncrementalPCA fitted on the card against
  the CPU. cuSOLVER's and LAPACK's float32 SVDs agree to ~1e-5 of a score
  column's range on the leading components; where singular values lie
  close, the components turn within their plane (up to 2.3e-4 of the
  range measured at column 34 of 80): the first 5 columns within 5e-5,
  every column within 1e-3; 1e-9 in float64."""
  import sisua_tpu_torch.data.analysis as TA
  from sisua_tpu_torch.analysis.decomposition import PCA
  for batch, n in ((4096, 100), (4096, 20), (256, 50)):
    monkeypatch.setattr(TA, "BATCH_SIZE", batch)
    card, cpu = _analyzer_pair()
    a = card.dimension_reduce(n_components=n)      # the default: 'cuda'
    b = cpu.dimension_reduce(n_components=n, device=CPU)
    assert card.uns["transcriptomic_pca_model"].components_.device.type \
        == "cuda"
    for c in range(a.shape[1]):
      np.testing.assert_allclose(a[:, c], b[:, c], rtol=0,
                                 atol=(5e-5 if c < 5 else 1e-3)
                                 * np.abs(b[:, c]).max())
  X = np.random.default_rng(2).gamma(0.6, 2.0, (700, 60))
  for n in (60, 10):
    got = PCA(n, random_state=3).fit_transform(X).cpu().numpy()
    want = PCA(n, random_state=3, device=CPU).fit_transform(X).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-9 * np.abs(want).max())


def test_analyzer_umap_on_the_card(dev, monkeypatch):
  """The kNN, the smooth-kNN calibration and the fuzzy graph on the card
  equal the CPU's (edges; weights 1e-12); the spectral initialization is
  finite on both (three blobs leave a degenerate null space, whose basis
  either LU picks arbitrarily, as the JAX package's does); from the same
  graph and start the SGD's first epoch within 2e-3 (its
  repulsion, clipped at ±4 where two points nearly meet, amplifies the
  float32 power's last-bit differences: 8.3e-4 measured on this ±10
  layout); two card runs give the same bits."""
  import sisua_tpu_torch.data.umap_impl as TU
  rng = np.random.default_rng(0)
  X = np.concatenate([c + rng.normal(0, 1, (150, 20))
                      for c in rng.normal(0, 8, (3, 20))])
  W = TU.fuzzy_simplicial_set(X)
  Wc = TU.fuzzy_simplicial_set(X, device=CPU)
  np.testing.assert_array_equal(W.row, Wc.row)
  np.testing.assert_array_equal(W.col, Wc.col)
  np.testing.assert_allclose(W.data, Wc.data, rtol=1e-12)
  init = TU._spectral_init(Wc.tocsr(), 2, 4, device=CPU)
  assert init.shape == (450, 2) and np.isfinite(
      TU._spectral_init(Wc.tocsr(), 2, 4, device="cuda")).all()
  monkeypatch.setattr(TU, "fuzzy_simplicial_set", lambda *a, **k: Wc)
  monkeypatch.setattr(TU, "_spectral_init", lambda *a, **k: init.copy())
  a = TU.fit_umap(X, n_epochs=1, random_state=4)
  b = TU.fit_umap(X, n_epochs=1, random_state=4, device=CPU)
  np.testing.assert_allclose(a, b, rtol=0, atol=2e-3)
  np.testing.assert_array_equal(TU.fit_umap(X, n_epochs=40, random_state=4),
                                TU.fit_umap(X, n_epochs=40, random_state=4))


def test_analyzer_rank_tests_on_the_card_equal_cpu(dev):
  """Welch's t and the Mann-Whitney U on the card: the CPU's names, scores
  and p-values (the sums run in numpy's order on both)."""
  card, cpu = _analyzer_pair()
  for method in ("t-test", "wilcoxon"):
    a = card.rank_vars_groups(method=method)
    b = cpu.rank_vars_groups(method=method, device=CPU)
    assert list(a) == list(b)
    for g in a:
      np.testing.assert_array_equal(a[g]["names"], b[g]["names"])
      np.testing.assert_allclose(a[g]["scores"], b[g]["scores"], rtol=1e-6)
      np.testing.assert_allclose(a[g]["pvals"], b[g]["pvals"], rtol=1e-6)
