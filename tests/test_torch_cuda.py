"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `cuda` and skips where torch has no CUDA device.
The file imports neither jax nor the reference package, so it also runs on
a GPU machine without them:

    PYTHONPATH=src python -m pytest -q --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: K1 (entry CAT) FULL_FP32 exact, MIXED flip rate < 5e-4
against the plain version on the CPU, and exact against the plain version
on the card (leaders off the 4x4 lattice, an all-invalid pass, |Δ| on both
sides of 464), and the same rule for `ops.stream_hierarchical_test_cuda`
at 64² against its CPU twin, lists and Stage-1 masks exact; K2 (fused
blend) rgb/trans atol 2e-4, counters exact (also
with sparse masks, ragged K and carried state; a batch of two frames
folded into the tile axis equal to per-frame launches bit for bit, K1 and
K2 both; an LOD build bit-equal across two runs from one seed, and an LOD
frame through K1 and K2 within 2e-4 of its plain versions; a frame
tile-sharded over four virtual shards of the card equal to the
single-device frame bit for bit; a scene trained 3 steps on the card,
served through K1 and K2 within 2e-4 of the all-"torch" frame; the LM's
float32 forward, prefill and decode logits on the card within rtol 1e-4
of the CPU's, and the dense LM over four virtual shards against one
device on the card: loss 1e-5, updates 1e-3 lr, replicas bit-equal,
logits 1e-4); K4 (dense CAT)
exact
under FULL_FP32 and MIXED; K3 (full-sweep blend) rgb/trans atol 1e-6;
the kernels' fp16/fp8 rounding (`prtu.alg1_quant`) bit-equal to the plain
quantizer, NaN matching any NaN. The
seeded numpy operand makers are shared with `test_torch_kernels.py` and
`test_torch_dense.py`, which hold the same wrappers against the
reference's Pallas kernels on the CPU.

One test here needs no card: an edited shared header (`csrc/*.cuh`)
changes the library name of every kernel, so no stale build is loaded.
"""
import shutil

import numpy as np
import pytest
import torch

from repro_torch.core.precision import (FULL_FP32, FULL_FP8, MIXED,
                                        PrecisionScheme, _quant)
from repro_torch.kernels import build, prtu, render

T_TILES, K_ENTRIES = 8, 256


def leader_coords():
    r = np.arange(4, dtype=np.float32) * 4
    gy, gx = np.meshgrid(r, r, indexing="ij")
    loc = np.stack([gx.reshape(-1), gy.reshape(-1)], -1)
    return loc + 0.5, loc + 3.5


def tile_origins(t):
    i = np.arange(t)
    return np.stack([(i % 4) * 16, (i // 4) * 16], -1).astype(np.float32)


def gaussian_features(rng, t, k):
    """Per-entry means near their tile, conics of 0.5-4.5 px sigmas."""
    mu = tile_origins(t)[:, None, :] + rng.uniform(-22, 38, (t, k, 2))
    s = rng.uniform(0.5, 4.5, (t, k, 2))
    rho = rng.uniform(-0.8, 0.8, (t, k))
    sxx, syy, sxy = s[..., 0] ** 2, s[..., 1] ** 2, rho * s[..., 0] * s[..., 1]
    det = sxx * syy - sxy * sxy
    conic = np.stack([syy / det, -sxy / det, sxx / det], -1)
    return mu.astype(np.float32), conic.astype(np.float32)


def cat_operands(seed, t=T_TILES, k=K_ENTRIES):
    rng = np.random.default_rng(seed)
    mu, conic = gaussian_features(rng, t, k)
    lhs = np.log(255 * rng.uniform(0.01, 0.99, (t, k))).astype(np.float32)
    lhs[rng.random((t, k)) < 0.1] = -np.inf                 # invalid slots
    spiky = (rng.random((t, k)) < 0.4).astype(np.int8)
    top, bot = leader_coords()
    return top, bot, tile_origins(t), mu, conic, lhs, spiky


def dense_cat_operands(seed, m=512, n=700):
    """(p_top, p_bot) of m mini-tiles of a 64-px-wide image, and n
    Gaussians spread over it, a tenth of them culled (lhs = -inf)."""
    rng = np.random.default_rng(seed)
    i = np.arange(m)
    orig = np.stack([(i % 16) * 4, (i // 16) * 4], -1).astype(np.float32)
    _, conic = gaussian_features(rng, 1, n)
    mu = rng.uniform(-8, 72, (n, 2)).astype(np.float32)
    lhs = np.log(255 * rng.uniform(0.01, 0.99, n)).astype(np.float32)
    lhs[rng.random(n) < 0.1] = -np.inf
    spiky = (rng.random(n) < 0.4).astype(np.int8)
    return orig + 0.5, orig + 3.5, mu, conic[0], lhs, spiky


def far_band_operands(seed, rows=2, n=192):
    """K4's operands on a 1024-px-wide band of `rows` mini-tile rows (256
    mini-tiles a row, image row-major) and n wide Gaussians (conic 1e-6,
    lhs 5: every corner passes unless its weight is NaN or inf) whose
    leader deltas straddle +-464 px: a third in x only (means inside the
    band's rows, x anywhere from -100 to 1124), a third mostly in y
    (means 430-470 px above or below the band, x near its middle), a
    third in both; one in ten culled."""
    rng = np.random.default_rng(seed)
    width = 256
    i = np.arange(rows * width)
    orig = np.stack([(i % width) * 4, (i // width) * 4], -1).astype(
        np.float32)
    height = 4 * rows
    side = rng.integers(0, 2, n) * 2 - 1                  # above or below
    off = rng.uniform(430, 470, n)
    far_y = np.where(side < 0, -off, height + off)
    mu_x = rng.uniform(-100, 1124, n)
    mu_y = rng.uniform(0, height, n)
    kind = np.arange(n) % 3                               # x, y, both
    mu_x = np.where(kind == 1, rng.uniform(460, 564, n), mu_x)
    mu_y = np.where(kind == 0, mu_y, far_y)
    mu = np.stack([mu_x, mu_y], -1).astype(np.float32)
    conic = np.tile(np.array([1e-6, 0.0, 1e-6], np.float32), (n, 1))
    lhs = np.full(n, 5.0, np.float32)
    lhs[rng.random(n) < 0.1] = -np.inf
    spiky = (rng.random(n) < 0.4).astype(np.int8)
    return orig + 0.5, orig + 3.5, mu, conic, lhs, spiky


def far_pair_masks(ops, coord_prec="fp32"):
    """(both, one) (M, N) bool: pairs whose two leader x deltas, or two
    leader y deltas, exceed 464 px in magnitude; pairs where exactly one
    delta of an axis does (and no axis has both). Coordinates rounded to
    `coord_prec` first, as Alg. 1 does."""
    top, bot, mu = (torch.from_numpy(x) for x in ops[:3])
    q = lambda x: _quant(x, coord_prec)  # noqa: E731
    both = torch.zeros((top.shape[0], mu.shape[0]), dtype=torch.bool)
    count = torch.zeros_like(both, dtype=torch.int32)
    for a in (0, 1):
        ft = ~((q(top[:, a])[:, None] - q(mu[:, a])[None]).abs() <= 464)
        fb = ~((q(bot[:, a])[:, None] - q(mu[:, a])[None]).abs() <= 464)
        both |= ft & fb
        count += (ft ^ fb).to(torch.int32)
    return both.numpy(), ((count > 0) & ~both).numpy()


def prec_kw(p):
    return dict(coord_prec=p.coord, delta_prec=p.delta, mul_prec=p.mul,
                acc_prec=p.acc, slack=p.slack)


def blend_operands(seed, t=T_TILES, k=K_ENTRIES):
    rng = np.random.default_rng(seed)
    mu, conic = gaussian_features(rng, t, k)
    op = rng.uniform(0.05, 0.95, (t, k, 1))
    feat = np.concatenate([mu, conic, op, np.zeros((t, k, 2))], -1)
    r = np.arange(16)
    dy, dx = np.meshgrid(r, r, indexing="ij")
    offs = np.stack([dx.reshape(-1), dy.reshape(-1)], -1) + 0.5
    pix = tile_origins(t)[:, None, :] + offs[None]
    colors = rng.random((t, k, 3))
    nvalid = rng.integers(0, k + 1, t)
    nvalid[0] = k                                          # one full list
    valid = (np.arange(k)[None] < nvalid[:, None]).astype(np.int8)
    allow = (rng.random((t, k, 16)) < 0.7).astype(np.int8)
    f32 = np.float32
    return (pix.astype(f32), feat.astype(f32), colors.astype(f32), valid,
            allow)


BLEND_CASES = ["full", "sparse", "single_bit", "interleaved",
               "all_invalid_tile", "ragged_k"]


def blend_case_operands(case, seed, t=T_TILES, k=K_ENTRIES):
    """`blend_operands` reshaped into one of BLEND_CASES: "full" as made;
    "sparse" 5% of the mini-tile bits set; "single_bit" one bit an entry;
    "interleaved" every slot valid or not at random (no prefix); an
    "all_invalid_tile" (tile 1 has no valid slot); "ragged_k" K + 72
    slots, not a multiple of K_BLK."""
    if case == "ragged_k":
        k += 72
    ops = list(blend_operands(seed, t=t, k=k))
    rng = np.random.default_rng(seed + 1000)
    shape = ops[4].shape
    if case == "sparse":
        ops[4] = (rng.random(shape) < 0.05).astype(np.int8)
    elif case == "single_bit":
        ops[4] = np.zeros(shape, np.int8)
        bit = rng.integers(0, shape[2], shape[:2])
        np.put_along_axis(ops[4], bit[..., None], 1, axis=2)
    elif case == "interleaved":
        ops[3] = (rng.random(shape[:2]) < 0.5).astype(np.int8)
    elif case == "all_invalid_tile":
        ops[3][1] = 0
    return tuple(ops)


def assert_fused_equal(got, want):
    """`got` (CPU tensors) against `want` (any array-likes): rgb and trans
    within 2e-4, every counter equal."""
    np.testing.assert_allclose(got.rgb.numpy(), np.asarray(want.rgb),
                               rtol=0, atol=2e-4)
    np.testing.assert_allclose(got.trans.numpy(), np.asarray(want.trans),
                               rtol=0, atol=2e-4)
    for name in ("processed", "blended", "entry_alive", "kblocks_processed"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)


def check_chained_route(cuda, prec):
    """`ops.stream_hierarchical_test_cuda` (Stage 1, one compaction pass,
    K1) at 64² against its plain twin on the CPU from the same `Projected`:
    lists, valid bits and Stage-1 masks equal, one K1 launch, the CAT mask
    within K1's flip rule and, under FULL_FP32, every counter equal."""
    from repro_torch.core import (SamplingMode, TileGrid, default_camera,
                                  project, random_scene)
    from repro_torch.core.gaussians import Projected
    from repro_torch.core.hierarchy import stream_hierarchical_test
    from repro_torch.kernels import ops

    scene = random_scene(torch.Generator().manual_seed(7), 400)
    proj = project(scene, default_camera(64, 64))
    grid, mode = TileGrid(64, 64), SamplingMode.SMOOTH_FOCUSED
    want = stream_hierarchical_test(proj, grid, mode, prec, k_max=400)
    before = prtu.launches
    got = ops.stream_hierarchical_test_cuda(
        Projected(*(x.to(cuda) for x in proj)), grid, mode, prec,
        k_max=400)
    assert prtu.launches == before + 1
    for f in ("lists", "valid", "entry_sub_mask", "overflow"):
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
    flips = int((got.entry_mini_mask.cpu() != want.entry_mini_mask).sum())
    assert flips == 0 if prec == FULL_FP32 else \
        flips < 5e-4 * want.entry_mini_mask.numel()
    if prec == FULL_FP32:
        assert all(torch.equal(got.counters[k].cpu(), v)
                   for k, v in want.counters.items())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("prec", ["fp32", "mixed"])
def test_entry_cat_kernel_matches_plain(cuda, prec, monkeypatch):
    """K1 against its plain version; then, with the int32 bound patched
    small, the same call split into row ranges (one launch each) equal to
    the single launch bit for bit."""
    p = {"fp32": FULL_FP32, "mixed": MIXED}[prec]
    ops = [torch.from_numpy(x) for x in cat_operands(3, t=64, k=512)]
    kw = dict(mode="smooth_focused", **prec_kw(p))
    want = prtu.prtu_entry_cat_mask(*ops, **kw)
    before = prtu.launches
    got = prtu.prtu_entry_cat_mask(*(x.to(cuda) for x in ops), **kw)
    assert prtu.launches == before + 1
    flips = int((got.cpu() != want).sum())
    assert flips == 0 if prec == "fp32" else flips < 5e-4 * want.numel()
    check_chained_route(cuda, p)

    monkeypatch.setattr(prtu, "ENTRY_INDEX_LIMIT", 10 * 512 * 16)
    ranges = prtu.entry_row_ranges(64, 512)
    assert len(ranges) == 8
    before = prtu.launches
    split = prtu.prtu_entry_cat_mask(*(x.to(cuda) for x in ops), **kw)
    assert prtu.launches == before + len(ranges)
    assert torch.equal(split, got)


@pytest.mark.cuda
def test_fused_blend_kernel_matches_plain(cuda):
    ops = [torch.from_numpy(x) for x in blend_operands(4, t=32, k=384)]
    want = render.blend_tiles_fused(*ops)
    before = render.launches
    got = render.blend_tiles_fused(*(x.to(cuda) for x in ops))
    assert render.launches == before + 1
    got = type(got)(*(x.cpu() if torch.is_tensor(x) else x for x in got))
    assert_fused_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("prec", ["fp32", "mixed"])
def test_dense_cat_kernel_matches_plain(cuda, prec):
    p = {"fp32": FULL_FP32, "mixed": MIXED}[prec]
    ops = [torch.from_numpy(x) for x in dense_cat_operands(5)]
    kw = dict(mode="smooth_focused", **prec_kw(p))
    want = prtu.prtu_cat_mask(*ops, **kw)
    before = prtu.dense_launches
    got = prtu.prtu_cat_mask(*(x.to(cuda) for x in ops), **kw)
    assert prtu.dense_launches == before + 1
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)


@pytest.mark.cuda
def test_full_blend_kernel_matches_plain(cuda):
    ops = [torch.from_numpy(x) for x in blend_operands(6, t=32, k=320)]
    want = render.blend_tiles(*ops)
    before = render.full_launches
    got = render.blend_tiles(*(x.to(cuda) for x in ops))
    assert render.full_launches == before + 1
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_full_blend_kernel_cases_match_plain(cuda):
    """K3 on each of BLEND_CASES (sparse and single-bit masks, invalid
    slots between valid ones, a tile with no valid slot, a ragged K):
    rgb/trans within 1e-6 of the plain version on the card, one launch
    each. The cases share one test so this file keeps few tests: the
    tier-1 run's file order (pytest-xdist, by test count) decides which
    worker runs the slowest file."""
    for case in BLEND_CASES:
        ops = [torch.from_numpy(x).to(cuda)
               for x in blend_case_operands(case, 14, t=32, k=320)]
        before = render.full_launches
        got = render.blend_tiles(*ops)
        assert render.full_launches == before + 1, case
        want = render.blend_tiles_plain(*ops)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=1e-6, msg=case)


def dense_kernel_flips(ops, kw, cuda, width=None) -> tuple[int, int]:
    """(flips, hits) of K4 (told `width`) against its plain version on the
    card; counts one launch."""
    dev = [torch.from_numpy(np.ascontiguousarray(x)).to(cuda) for x in ops]
    before = prtu.dense_launches
    got = prtu.prtu_cat_mask(*dev, **kw, width=width)
    assert prtu.dense_launches == before + 1
    want = prtu.prtu_cat_mask_plain(*dev, **kw)
    return int((got != want).sum()), int(want.sum())


FAR_BAND_PRECS = {"fp32": FULL_FP32, "mixed": MIXED, "fp8": FULL_FP8,
                  "fp8_delta": PrecisionScheme("fp32", "fp8", "fp32", "fp32")}


@pytest.mark.cuda
def test_dense_cat_kernel_geometry_and_instances(cuda):
    """K4 against its plain version on the card, 0 flips in each case (one
    test for all, so this file keeps few tests; see above):
    * a 1024-px-wide band of 16 mini-tile rows whose Gaussians straddle
      +-464 px, under FULL_FP32, MIXED, FULL_FP8 (coordinates above 464
      are NaN) and a fp8 delta with wide products, told the band's width
      (8x8 regions on the lattice, the fp8 skip on) or not (one band);
      under a fp8 delta no hit where both deltas of an axis pass 464;
    * blocks that do not tile the mask: a 64-px image (16 mini-tiles a
      row) cut to 200 rows (part of a last row, regions cut at the bottom),
      1300 Gaussians (not a multiple of the 512-column block or of 16) with
      runs of culled and NaN columns (whole blocks empty), under FULL_FP32
      and MIXED; then the same rows shuffled (off the lattice: the exact
      path);
    * each of the 27 (delta, mul, acc) instances, coordinates in fp16,
      fp32 and fp8 (fp16/fp8 deltas with fp16 products and sums take the
      float16 path unless the coordinates are fp32 or 1 - slack <= 0),
      slack 0, 0.15 and 1.5 and every sampling mode in turn."""
    band = far_band_operands(22, rows=16, n=1500)
    for name, p in FAR_BAND_PRECS.items():
        kw = dict(mode="uniform_dense", **prec_kw(p))
        for width in (256, None):
            flips, hits = dense_kernel_flips(band, kw, cuda, width)
            assert flips == 0 and hits > 0, (name, width)
            if p.delta == "fp8":
                dev = [torch.from_numpy(x).to(cuda) for x in band]
                got = prtu.prtu_cat_mask(*dev, **kw, width=width)
                both, _ = far_pair_masks(band, p.coord)
                assert not got.cpu().numpy()[both].any(), (name, width)

    ragged = list(dense_cat_operands(15, m=200, n=1300))
    ragged[4] = ragged[4].copy()
    ragged[4][0:530] = -np.inf               # the first block, and more
    ragged[4][700:760] = np.nan
    perm = np.random.default_rng(15).permutation(200)
    shuffled = [ragged[0][perm], ragged[1][perm]] + ragged[2:]
    for p in (FULL_FP32, MIXED):
        kw = dict(mode="smooth_focused", **prec_kw(p))
        for ops in (ragged, shuffled):
            flips, hits = dense_kernel_flips(ops, kw, cuda, width=16)
            assert flips == 0 and hits > 0, p

    ops = dense_cat_operands(16, m=256, n=700)
    precs = ["fp32", "fp16", "fp8"]
    modes = ["uniform_dense", "uniform_sparse", "smooth_focused",
             "spiky_focused"]
    i = 0
    for delta in precs:
        for mul in precs:
            for acc in precs:
                for coord in ("fp16", "fp32", "fp8"):
                    kw = dict(mode=modes[i % 4], coord_prec=coord,
                              delta_prec=delta, mul_prec=mul, acc_prec=acc,
                              slack=(0.0, 0.15, 1.5)[i % 3])
                    i += 1
                    flips, _ = dense_kernel_flips(ops, kw, cuda, width=16)
                    assert flips == 0, kw


@pytest.mark.cuda
@pytest.mark.parametrize("prec", ["fp32", "mixed"])
def test_entry_cat_kernel_off_lattice_matches_plain(cuda, prec):
    """Leaders off the 4x4 lattice: the kernel's per-mini-tile path, 0
    flips against the plain version on the card."""
    p = {"fp32": FULL_FP32, "mixed": MIXED}[prec]
    ops = list(cat_operands(7, t=64, k=512))
    ops[0], ops[1] = ops[0].copy(), ops[1].copy()
    ops[0][5, 0] += 0.25                     # top leader 5 leaves column 1
    ops[1][10, 1] -= 0.5                     # bottom leader 10 leaves row 2
    ops = [torch.from_numpy(x).to(cuda) for x in ops]
    kw = dict(mode="smooth_focused", **prec_kw(p))
    before = prtu.launches
    got = prtu.prtu_entry_cat_mask(*ops, **kw)
    assert prtu.launches == before + 1
    want = prtu.prtu_entry_cat_mask_plain(*ops, **kw)
    assert int(want.sum()) > 0
    assert int((got != want).sum()) == 0


@pytest.mark.cuda
def test_entry_cat_kernel_all_invalid_pass_is_zero(cuda):
    """A pass with no valid entry (lhs = -inf everywhere, as the empty
    spill passes of a frame): every flag 0."""
    ops = list(cat_operands(8, t=64, k=512))
    ops[5] = np.full_like(ops[5], -np.inf)
    ops = [torch.from_numpy(x).to(cuda) for x in ops]
    got = prtu.prtu_entry_cat_mask(*ops, mode="uniform_dense",
                                   **prec_kw(MIXED))
    assert got.shape == (64, 512, 16) and int(got.abs().sum()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("prec", ["fp32", "mixed", "fp8_delta"])
def test_entry_cat_kernel_fp8_overflow_band(cuda, prec):
    """Means 0-650 px from their tile, wide Gaussians that every leader
    passes unless a delta overflows: 0 flips against the plain version on
    the card; with a fp8 delta and wide products (fault F1) mini-tiles hit
    at |Δ| up to 464, and none whose leader deltas all pass 464 in x or
    all in y (NaN, not a saturated 448)."""
    p = {"fp32": FULL_FP32, "mixed": MIXED,
         "fp8_delta": PrecisionScheme("fp32", "fp8", "fp32", "fp32")}[prec]
    t, k = 16, 256
    rng = np.random.default_rng(9)
    ops = list(cat_operands(9, t=t, k=k))
    ops[3] = (ops[2][:, None, :] + 8.0
              + rng.uniform(-650, 650, (t, k, 2))).astype(np.float32)
    ops[4] = np.tile(np.array([1e-6, 0.0, 1e-6], np.float32), (t, k, 1))
    ops[5] = np.full((t, k), 5.0, np.float32)
    top, bot, origins, mu = ops[:4]
    dev = [torch.from_numpy(x).to(cuda) for x in ops]
    kw = dict(mode="uniform_dense", **prec_kw(p))
    got = prtu.prtu_entry_cat_mask(*dev, **kw)
    want = prtu.prtu_entry_cat_mask_plain(*dev, **kw)
    assert int((got != want).sum()) == 0
    if prec != "fp8_delta":
        return
    got = got.cpu().numpy()
    far = np.zeros(got.shape, bool)
    for a in (0, 1):                        # both leaders' deltas on axis a
        lead_t = origins[:, None, None, a] + top[None, None, :, a]
        lead_b = origins[:, None, None, a] + bot[None, None, :, a]
        m = mu[:, :, None, a]
        far |= (np.abs(lead_t - m) > 464) & (np.abs(lead_b - m) > 464)
    near_edge = np.abs(np.abs(origins[:, None, None, 0] + top[None, None, :, 0]
                              - mu[:, :, None, 0]) - 432) < 32
    assert far.any() and not got[far].any()
    assert got[near_edge & ~far].any()


def check_folded_batch_equals_per_frame(cuda):
    """Two 64² frames of one SPILL plan folded into the tile axis: each
    pass's one K1 launch gives the per-frame launches' masks, and the
    folded K2 chain (one launch a pass) each frame's own chain, bit for
    bit."""
    from repro_torch.core import (GridConfig, RasterConfig, RenderPlan,
                                  StreamConfig, TestConfig, orbit_camera,
                                  random_scene)
    from repro_torch.core import hierarchy as H
    from repro_torch.kernels import ops
    gen = torch.Generator().manual_seed(15)
    scene = random_scene(gen, 3000, scale_range=(-2.5, -2.0),
                         device=cuda)
    plan = RenderPlan(grid=GridConfig(64, 64),
                      test=TestConfig(backend="cuda"),
                      stream=StreamConfig(k_max=128, overflow="spill",
                                          max_spill_passes=2),
                      raster=RasterConfig(fused=True))
    cams = [orbit_camera(a, 64, 64, device=cuda) for a in (0.2, 1.9)]
    pss = [plan.preprocess(scene, c) for c in cams]
    streams = [plan.stage1_compact(ps) for ps in pss]
    grid = pss[0].grid
    fold = H.fold_frames([ps.proj for ps in pss], grid)
    mode, prec = plan.test.mode, plan.test.precision
    passes = []
    for i in range(plan.n_passes):
        lists = [s[i].lists for s in streams]
        valid = [s[i].valid for s in streams]
        before = prtu.launches
        folded = ops.entry_cat_mask_cuda(
            fold.proj, grid, fold.ids(lists), fold.cat(valid), mode, prec,
            tile_origins=fold.tile_origins)
        assert prtu.launches == before + 1
        singles = [ops.entry_cat_mask_cuda(ps.proj, grid, ls, v, mode, prec)
                   for ps, ls, v in zip(pss, lists, valid)]
        assert torch.equal(folded, torch.cat(singles))
        passes.append([(ls, v, m) for ls, v, m in zip(lists, valid,
                                                      singles)])
    before = render.launches
    batch = ops.render_tiles_fused_frames(fold, grid, passes,
                                          overflows=[False, False])
    assert render.launches == before + plan.n_passes
    for b, ps in enumerate(pss):
        out, counters = ops.render_tiles_fused_passes(
            ps.proj, grid, [p[b] for p in passes])
        for x, y in zip(batch[b][0], out):
            assert torch.equal(x, y)
        for k in counters:
            assert torch.equal(batch[b][1][k], counters[k]), k


def check_lod_build_and_render(cuda):
    """`build_lod` on the card twice from one generator seed: every tensor
    bit-equal (order-fixed sums, no float atomics). Then a 64² LOD frame
    through K1 and K2 (one launch each a pass of the plan) within 2e-4 of
    the same LOD plan's plain versions on the card, lod_* counters equal."""
    import dataclasses
    from repro_torch.core import (GridConfig, RasterConfig, RenderPlan,
                                  StreamConfig, TestConfig, default_camera,
                                  orbit_camera, random_scene)
    from repro_torch.lod import LODConfig, build_lod, measure_lod_k_max
    scene = random_scene(torch.Generator().manual_seed(2), 4096,
                         extent=8.0, scale_range=(-2.9, -2.2), stretch=3.0,
                         opacity_range=(-1.0, 3.0), device=cuda)
    probes = [default_camera(64, 64, 30.0, device=cuda),
              orbit_camera(0.4, 64, 64, fov_deg=30.0, device=cuda)]
    cfg = LODConfig(num_clusters=64, probe_k_max=128, probe_passes=2,
                    min_bucket=256)
    grid = GridConfig(64, 64)
    a, b = (build_lod(scene, probes, cfg, grid=grid,
                      generator=torch.Generator(cuda).manual_seed(4))
            for _ in range(2))
    for f in ("member_cluster", "centers", "radii", "counts", "starts",
              "mass"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert torch.equal(a.scene.means, b.scene.means)
    k = measure_lod_k_max(a, probes[:1], cfg, grid=grid)
    plan = RenderPlan(grid=grid, test=TestConfig(backend="cuda"),
                      stream=StreamConfig(k_max=64, overflow="spill",
                                          max_spill_passes=-(-k // 64)),
                      raster=RasterConfig(fused=True), lod=cfg)
    before = (prtu.launches, render.launches)
    out, c = plan.render_lod_with_stats(a, probes[0])
    assert (prtu.launches - before[0], render.launches - before[1]) == \
        (plan.n_passes, plan.n_passes)
    plain = dataclasses.replace(plan, test=TestConfig(),
                                raster=RasterConfig())
    want, wc = plain.render_lod_with_stats(a, probes[0])
    assert float((out.image - want.image).abs().max()) <= 2e-4
    assert 0.0 < float(c["lod_selection_ratio"]) < 1.0
    for key in ("lod_clusters_selected", "lod_gaussians_selected",
                "lod_bucket"):
        assert torch.equal(c[key], wc[key]), key


def check_sharded_equals_single(cuda):
    """A 64² SPILL frame tile-sharded over four virtual shards of the card
    (`[cuda] * 4`): K1 and K2 launched 4 times a pass on row blocks whose
    origins do not start at 0, and the frame equal to the single-device
    frame bit for bit (every RenderOut field, every counter of the single
    frame)."""
    import dataclasses
    from repro_torch.core import (GridConfig, RasterConfig, RenderPlan,
                                  ShardConfig, StreamConfig, TestConfig,
                                  orbit_camera, random_scene)
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.serving.sharding import tile_mesh
    scene = random_scene(torch.Generator().manual_seed(15), 3000,
                         scale_range=(-2.5, -2.0), device=cuda)
    plan = RenderPlan(grid=GridConfig(64, 64),
                      test=TestConfig(backend="cuda"),
                      stream=StreamConfig(k_max=128, overflow="spill",
                                          max_spill_passes=2),
                      raster=RasterConfig(fused=True))
    cam = orbit_camera(0.2, 64, 64, device=cuda)
    want, wc = plan.render_with_stats(scene, cam)
    before = (prtu.launches, render.launches)
    with use_mesh(tile_mesh(4, devices=[cuda] * 4)):
        got, gc = dataclasses.replace(
            plan, shard=ShardConfig(tile_shards=4)).render_with_stats(
                scene, cam)
    assert (prtu.launches - before[0], render.launches - before[1]) == \
        (4 * plan.n_passes, 4 * plan.n_passes)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    for k in wc:
        assert torch.equal(gc[k], wc[k]), k
    assert float(gc["tile_shards"]) == 4.0


def check_fit_on_card(cuda):
    """Train unfused, serve fused: 3 Adam steps on the card through the
    all-"torch" plan (no kernel launched, finite gradients, the loss
    falling), then the trained scene through K1 and K2 within 2e-4 of the
    all-"torch" frame."""
    import dataclasses
    from repro_torch.core import (FULL_FP32, GridConfig, RasterConfig,
                                  RenderPlan, StreamConfig, TestConfig,
                                  default_camera, random_scene, training)
    gen = torch.Generator(device=cuda).manual_seed(19)
    scene = random_scene(gen, 500, scale_range=(-2.8, -2.0), stretch=3.5,
                         opacity_range=(-1.0, 1.0))
    cam = default_camera(64, 64, device=cuda)
    y, x = torch.meshgrid(torch.arange(64, device=cuda) / 64,
                          torch.arange(64, device=cuda) / 64, indexing="ij")
    target = torch.stack([0.5 + 0.4 * torch.sin(3 * x + 2 * y),
                          0.5 + 0.4 * torch.cos(2 * y),
                          0.5 + 0.4 * torch.sin(4 * x * y)], -1)
    plan = RenderPlan(grid=GridConfig(64, 64),
                      test=TestConfig(precision=FULL_FP32),
                      stream=StreamConfig(k_max=500))
    _, grads = training.value_and_grad(scene, cam, target, plan, 0.2)
    assert all(bool(torch.isfinite(getattr(grads, f)).all())
               for f in training.SCENE_FIELDS)
    before = (prtu.launches, render.launches)
    trained, losses = training.fit(scene, cam, target, plan, steps=3)
    assert (prtu.launches, render.launches) == before
    assert losses.shape == (3,) and bool(torch.isfinite(losses).all())
    assert float(losses[-1]) < float(losses[0])
    served = dataclasses.replace(plan, test=TestConfig(precision=FULL_FP32,
                                                       backend="cuda"),
                                 raster=RasterConfig(fused=True))
    with torch.no_grad():
        want = plan.render(trained, cam).image
        got = served.render(trained, cam).image
    assert (prtu.launches - before[0], render.launches - before[1]) == (1, 1)
    assert float((got - want).abs().max()) <= 2e-4


def check_lm_card_vs_cpu(cuda):
    """The LM on the card against the CPU: reduced qwen1.5-0.5b under
    float32 compute, one set of weights (drawn on the CPU, copied), by
    `models.parity.lm_parity` (the smoke's 10d helper): forward, prefill
    and 8 teacher-forced decode steps under float32 caches within rtol
    1e-4 and atol 1e-4 x max|logit|; under the model's bf16 caches each
    cache element within one bf16 ulp of the CPU's (past float32 noise),
    the caches on the card."""
    import dataclasses
    from repro_torch.configs import get_arch, reduced
    from repro_torch.models import Model
    from repro_torch.models.parity import failures, lm_parity
    cfg = dataclasses.replace(reduced(get_arch("qwen1.5-0.5b")),
                              dtype="float32", attn_chunk=8)
    cpu = Model(cfg, device="cpu", seed=0)
    card = Model(cfg, device="meta")
    card.load_state_dict({k: v.to(cuda) for k, v in
                          cpu.state_dict().items()}, assign=True)
    gen = torch.Generator().manual_seed(20)
    prompt = torch.randint(0, cfg.vocab_size, (2, 20), generator=gen)
    toks = torch.randint(0, cfg.vocab_size, (2, 8), generator=gen)
    assert card.init_caches(2, 8)["kv"]["kv"][0].device.type == "cuda"
    result = lm_parity(card, cpu, prompt, toks, cuda, "cpu")
    assert not failures(result), result


def check_lm_mesh_on_card(cuda):
    """The dense LM over four virtual shards of the card, (data=2,
    model=2), against one device on the card: reduced qwen1.5-0.5b under
    float32 compute, its loss within 1e-5 relative, one driver step's
    updates within 1e-3 lr plus two ulps where the gradient exceeds 1e-2
    of its leaf's largest, every replica bit-equal; prefill and 8 decode
    steps by `models.parity.lm_parity` (float32 caches at rtol 1e-4, the
    bf16 caches within one ulp)."""
    import dataclasses
    from repro_torch.checkpoint.ckpt import flatten
    from repro_torch.configs import get_arch, reduced
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import tokens as data
    from repro_torch.distributed.sharding import Mesh, Sharded
    from repro_torch.launch import train
    from repro_torch.models import Model
    from repro_torch.models.parity import failures, lm_parity
    from repro_torch.optim import adamw
    cfg = dataclasses.replace(reduced(get_arch("qwen1.5-0.5b")),
                              dtype="float32", attn_chunk=8)
    mesh = Mesh([[cuda, cuda], [cuda, cuda]])
    one = Model(cfg, device=cuda, seed=2)
    sh = Model(cfg, device=cuda, seed=2, mesh=mesh)
    batch = data.synthetic_batch(cfg, ShapeConfig("t", "train", 32, 4), 0,
                                 device=cuda)
    l1, l2 = float(one.loss(batch)), float(sh.loss(batch))
    assert abs(l1 - l2) <= 1e-5 * abs(l1)
    args = train.parser().parse_args(["--arch", cfg.name, "--steps", "2"])
    opt_cfg = train.opt_config(args, cfg)
    before = [{k: v.clone() for k, v in m.state_dict().items()}
              for m in (one, sh)]
    states = []
    for m in (one, sh):
        step = train.make_step(m, opt_cfg, train.CompressionConfig())
        states.append(step(adamw.init(m.params(), opt_cfg), batch)[0])
    lr = float(adamw.lr_at(states[0].step, opt_cfg))
    grads = {k: v for k, v in zip(sorted(before[0]), [
        m / (1 - opt_cfg.b1) for m in flatten(states[0].m)])}
    got, want = sh.state_dict(), one.state_dict()
    for k, g in grads.items():
        sel = g.abs() > 1e-2 * g.abs().max()
        d = ((got[k] - before[1][k]) - (want[k] - before[0][k])).abs()
        mag = got[k].abs()
        ulp = torch.nextafter(mag, torch.full_like(mag, float("inf"))) - mag
        assert bool((d - 2 * ulp)[sel].max() <= 1e-3 * lr), k
    for t in flatten((sh.params(), states[1])):
        if isinstance(t, Sharded):
            for grp in t.sharding.replica_groups():
                assert all(torch.equal(t.pieces[i], t.pieces[grp[0]])
                           for i in grp[1:])
    gen = torch.Generator().manual_seed(22)
    prompt = torch.randint(0, cfg.vocab_size, (4, 16), generator=gen)
    toks = torch.randint(0, cfg.vocab_size, (4, 8), generator=gen)
    result = lm_parity(sh, one, prompt, toks, cuda, cuda)
    assert not failures(result), result


@pytest.mark.cuda
def test_fused_blend_kernel_sparse_masks_carried_state(cuda):
    """K2 with ~30% of the mini-tile bits set, wide opaque entries (pixels
    and whole tiles die mid-chunk), a ragged K = 300 and state carried from
    a first pass: rgb/trans within 2e-4 of the plain version, counters
    equal. Then a folded two-frame batch through K1 and K2 against the
    per-frame launches (`check_folded_batch_equals_per_frame`), an LOD
    build and frame on the card (`check_lod_build_and_render`), and a
    frame tile-sharded over four virtual shards of the card against the
    single-device frame (`check_sharded_equals_single`), a 3-step fit
    on the card whose scene is then served through K1 and K2
    (`check_fit_on_card`), the LM's float32 logits on the card
    against the CPU (`check_lm_card_vs_cpu`), and the dense LM over four
    virtual shards of the card against one device
    (`check_lm_mesh_on_card`)."""
    t = 24
    rng = np.random.default_rng(11)
    first = [torch.from_numpy(x) for x in blend_operands(12, t=t, k=128)]
    ops = list(blend_operands(11, t=t, k=300))
    ops[1][..., 5] = rng.uniform(0.6, 0.99, ops[1].shape[:2])
    ops[1][..., 2:5] /= 64                  # sigmas of 4-36 px
    ops[4] = (rng.random(ops[4].shape) < 0.3).astype(np.int8)
    ops = [torch.from_numpy(x) for x in ops]
    a = render.blend_tiles_fused(*first)
    init = (a.trans, a.rgb, a.processed, a.blended)
    want = render.blend_tiles_fused(*ops, init=init)
    assert bool(((a.trans >= 1e-4) & (want.trans < 1e-4)).any())
    assert bool((want.kblocks_processed
                 < render.kblock_bound_of(ops[3])).any())
    got = render.blend_tiles_fused(*(x.to(cuda) for x in ops),
                                   init=tuple(x.to(cuda) for x in init))
    got = type(got)(*(x.cpu() if torch.is_tensor(x) else x for x in got))
    assert_fused_equal(got, want)
    check_folded_batch_equals_per_frame(cuda)
    check_lod_build_and_render(cuda)
    check_sharded_equals_single(cuda)
    check_fit_on_card(cuda)
    check_lm_card_vs_cpu(cuda)
    check_lm_mesh_on_card(cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fp16", "fp8"])
@pytest.mark.parametrize("paired", [False, True])
def test_alg1_quant_matches_plain_quantizer(cuda, kind, paired):
    """The kernels' rounding step on 2**22 float32 patterns: every
    e4m3/fp16 boundary region (around 448-480, the subnormals, +-inf, NaN)
    and random bits, bit-equal to the plain quantizer (or both NaN)."""
    rng = np.random.default_rng(13)
    edges = np.array([0.0, -0.0, 448, 449, 463.99, 464, 464.01, 480, 65504,
                      65520, np.inf, -np.inf, np.nan, 2 ** -9, 2 ** -10,
                      3 * 2 ** -11, 1e-40, -1e-40], np.float32)
    band = np.linspace(-500, 500, 1 << 20, dtype=np.float32)
    tiny = np.linspace(-2 ** -5, 2 ** -5, 1 << 20, dtype=np.float32)
    bits = rng.integers(0, 2 ** 32, (1 << 21) - edges.size,
                        dtype=np.uint64).astype(np.uint32).view(np.float32)
    x = torch.from_numpy(np.concatenate([edges, band, tiny, bits]))
    want = prtu.alg1_quant(x, kind)
    got = prtu.alg1_quant(x.to(cuda), kind, paired=paired).cpu()
    same = (got.view(torch.int32) == want.view(torch.int32)) \
        | (got.isnan() & want.isnan())
    assert bool(same.all()), x[~same][:8]


def test_edited_header_rebuilds_both_prtu_kernels(tmp_path, monkeypatch):
    """Both PRTU sources include csrc/alg1.cuh: editing it must change the
    library each of them loads."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    sources = [csrc / "prtu_entry.cu", csrc / "prtu_dense.cu"]
    before = [build._target(s) for s in sources]
    header = csrc / "alg1.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = [build._target(s) for s in sources]
    assert all(a != b for a, b in zip(after, before))
    assert build._target(csrc / "blend_full.cu").name.startswith(
        "blend_full-")
