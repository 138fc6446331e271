"""The port's kernel wrappers against the reference's Pallas kernels.

On the CPU each wrapper runs its kernel's plain PyTorch version; the
reference runs its Pallas kernel in interpret mode (K <= 256). Tolerances:

  K1 (entry CAT)      FULL_FP32 exact (every sampling mode), MIXED flip
                      rate < 5e-4
  K2 (fused blend)    rgb/trans atol 2e-4, counters exact, also when the
                      list is split into two chained passes
  fused-blend oracle  counters exact, rgb/trans atol 2e-4
  entry_alive prefix  within each K_BLK chunk, entry_alive == valid & (kk <=
                      some prefix end): exact for the plain fused blend; for
                      the reference's Pallas kernel (in-block cumprod) a break
                      is allowed only in a tile whose transmittance comes
                      within 1e-6 of T_EPS
  leader lattice      exact

The CUDA kernels themselves are held against these plain versions on the
card by `test_torch_cuda.py`, which also holds the seeded operand builders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.culling import TileGrid as JGrid
from repro.core.gaussians import project as jproject
from repro.kernels import prtu as jprtu
from repro.kernels import ref as jref
from repro.kernels import render as jrender

from repro_torch import convert
from repro_torch.core import (GridConfig, ProjectedScene, RasterConfig,
                              Renderer, StreamConfig, TestConfig)
from repro_torch.core.cat import leader_corners
from repro_torch.core.culling import TileGrid
from repro_torch.core.precision import (FULL_FP32, MIXED, FULL_FP8,
                                        PrecisionScheme)
from repro_torch.core.raster import T_EPS, entry_alpha
from repro_torch.kernels import build, ops as kops, prtu, ref, render

from test_torch_cuda import (T_TILES, K_ENTRIES, assert_fused_equal,
                             blend_operands, cat_operands,
                             dense_cat_operands, leader_coords, prec_kw)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's tensors here are tiny: one intra-op thread keeps torch's
    worker threads from competing with the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_cat(ops, p: PrecisionScheme, mode="smooth_focused"):
    want = np.asarray(jprtu.prtu_entry_cat_mask(
        *(jnp.asarray(x) for x in ops), mode=mode, **prec_kw(p),
        interpret=True))
    got = prtu.prtu_entry_cat_mask(*(torch.from_numpy(x) for x in ops),
                                   mode=mode, **prec_kw(p)).numpy()
    return got, want


@pytest.mark.parametrize("prec", ["fp32", "mixed", "fp8"])
def test_entry_cat_matches_pallas_kernel(prec):
    p = {"fp32": FULL_FP32, "mixed": MIXED, "fp8": FULL_FP8}[prec]
    got, want = run_cat(cat_operands(0), p)
    assert got.shape == (T_TILES, K_ENTRIES, 16) and got.dtype == np.int8
    flips = int(np.sum(got != want))
    if prec == "fp32":
        assert flips == 0
    else:
        assert flips < 5e-4 * want.size, flips


@pytest.mark.parametrize("mode", ["uniform_dense", "uniform_sparse",
                                  "spiky_focused"])
def test_entry_cat_modes_match_pallas_kernel(mode):
    """The other leader-pixel sampling modes (smooth_focused is above),
    each selecting corners per entry by its spikiness bit: exact at
    FULL_FP32."""
    got, want = run_cat(cat_operands(5), FULL_FP32, mode=mode)
    np.testing.assert_array_equal(got, want)


def test_entry_cat_fp8_overflow_never_hits():
    """F1 through the CTU: with Δ quantized to fp8 (and wide products), an
    entry 400 px from its Gaussian hits and one 470 px away never does —
    Δ = 470 is NaN in e4m3fn, not a saturated 448."""
    p = PrecisionScheme("fp32", "fp8", "fp32", "fp32")
    top, bot = leader_coords()
    ops = (top, bot, np.zeros((1, 2), np.float32),
           np.array([[[-400.0, 8.0], [-470.0, 8.0], [-463.0, 8.0]]],
                    np.float32),
           np.full((1, 3, 3), [1e-6, 0.0, 1e-6], np.float32),
           np.full((1, 3), 5.0, np.float32), np.zeros((1, 3), np.int8))
    got, want = run_cat(ops, p, mode="uniform_dense")
    np.testing.assert_array_equal(got, want)
    assert got[0, 0, 0] == 1 and got[0, 2, 0] == 1   # |Δ| 400.5, 463.5
    assert not got[0, 1].any()                       # |Δ| 470.5: NaN


@pytest.mark.parametrize("split", [None, 128])
def test_fused_blend_matches_pallas_kernel(split):
    ops = blend_operands(1)
    jops = [jnp.asarray(x) for x in ops]
    tops = [torch.from_numpy(x) for x in ops]
    if split is None:
        want = jrender.blend_tiles_fused(*jops, interpret=True)
        got = render.blend_tiles_fused(*tops)
    else:
        def seg(ops, lo, hi):
            pix, feat, col, valid, allow = ops
            return (pix, feat[:, lo:hi], col[:, lo:hi], valid[:, lo:hi],
                    allow[:, lo:hi])
        wa = jrender.blend_tiles_fused(*seg(jops, 0, split),
                                       interpret=True)
        want = jrender.blend_tiles_fused(
            *seg(jops, split, None),
            init=(wa.trans, wa.rgb, wa.processed, wa.blended), interpret=True)
        ga = render.blend_tiles_fused(
            *(x.contiguous() for x in seg(tops, 0, split)))
        got = render.blend_tiles_fused(
            *(x.contiguous() for x in seg(tops, split, None)),
            init=(ga.trans, ga.rgb, ga.processed, ga.blended))
        np.testing.assert_array_equal(ga.entry_alive.numpy(),
                                      np.asarray(wa.entry_alive))
    assert_fused_equal(got, want)
    assert got.kblocks_total == want.kblocks_total


def test_fused_blend_oracle_matches_reference():
    ops = blend_operands(2)
    want = jax.jit(jref.blend_tiles_fused_ref)(*(jnp.asarray(x) for x in ops))
    got = ref.blend_tiles_fused_ref(*(torch.from_numpy(x) for x in ops))
    for i in (0, 1):                                          # rgb, trans
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]),
                                   rtol=0, atol=2e-4)
    for i in (2, 3, 4, 5):                 # processed, blended, alive, kproc
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))
    assert got[6] == want[6]
    # The plain fused blend reports the oracle's counters.
    plain = render.blend_tiles_fused(*(torch.from_numpy(x) for x in ops))
    np.testing.assert_array_equal(plain.kblocks_processed.numpy(),
                                  got[5].numpy())
    np.testing.assert_array_equal(plain.entry_alive.numpy(), got[4].numpy())


def test_wrappers_refuse_what_the_kernels_do_not_take():
    """Only CPU tensors take the plain versions: any other non-CUDA device
    raises instead of falling back, and the operand check in front of every
    kernel launch rejects a wrong dtype, shape or layout."""
    meta = torch.device("meta")
    cat_ops = [torch.from_numpy(x).to(meta) for x in cat_operands(0, t=2)]
    with pytest.raises(ValueError, match="unsupported device"):
        prtu.prtu_entry_cat_mask(*cat_ops)
    blend_ops = [torch.from_numpy(x).to(meta)
                 for x in blend_operands(0, t=2, k=128)]
    with pytest.raises(ValueError, match="unsupported device"):
        render.blend_tiles_fused(*blend_ops)
    with pytest.raises(ValueError, match="unsupported device"):
        render.blend_tiles(*blend_ops)
    dense_ops = [torch.from_numpy(x).to(meta)
                 for x in dense_cat_operands(0, m=64, n=32)]
    with pytest.raises(ValueError, match="unsupported device"):
        prtu.prtu_cat_mask(*dense_ops)

    check = build.check_operand
    x = torch.zeros((4, 3))
    check("x", x, torch.float32, (4, 3), x.device)
    with pytest.raises(TypeError, match="dtype"):
        check("x", x.double(), torch.float32, (4, 3), x.device)
    with pytest.raises(ValueError, match="shape"):
        check("x", x, torch.float32, (4, 4), x.device)
    with pytest.raises(ValueError, match="contiguous"):
        check("x", x.t(), torch.float32, (3, 4), x.device)
    with pytest.raises(ValueError, match="expected meta"):
        check("x", x, torch.float32, (4, 3), meta)


def test_entry_row_ranges_split_at_the_index_bound(monkeypatch):
    """K1's wrapper launches once per row range of `entry_row_ranges`:
    the ranges cover every tile row once, in order, each under the int32
    bound (patched small here), and one range suffices below it. A fold
    of 4 frames at 1024² with 8192 entries a tile (16384 x 8192 x 16 =
    2**31) splits in two; only a single row past the bound raises."""
    assert prtu.entry_row_ranges(16384, 8192) == [(0, 8192), (8192, 16384)]
    assert prtu.entry_row_ranges(2 * 8160, 512) == [(0, 16320)]
    assert prtu.entry_row_ranges(0, 512) == [(0, 0)]
    with pytest.raises(ValueError, match="int32"):
        prtu.entry_row_ranges(1, 1 << 27)
    for limit in (16 * 64, 16 * 64 + 1, 1000, 5000):
        monkeypatch.setattr(prtu, "ENTRY_INDEX_LIMIT", limit)
        for t, k in ((1, 8), (7, 8), (64, 8), (37, 16), (300, 5)):
            ranges = prtu.entry_row_ranges(t, k)
            rows = [r for t0, t1 in ranges for r in range(t0, t1)]
            assert rows == list(range(t)), (limit, t, k, ranges)
            assert all(t1 > t0 for t0, t1 in ranges)
            assert all((t1 - t0) * k * prtu.MINITILES < limit
                       for t0, t1 in ranges), (limit, t, k, ranges)
            if t * k * prtu.MINITILES < limit:
                assert ranges == [(0, t)]
        with pytest.raises(ValueError, match="int32"):
            prtu.entry_row_ranges(4, limit)


def scene_blend_operands(scene, camera, size=64, k_max=256):
    """The fused blend's operands for the first pass of a real frame: the
    reference's projection of `scene`, the port's Stage 1 and CTU at
    FULL_FP32 (lists of at most k_max entries per tile)."""
    plan = Renderer(grid=GridConfig(size, size),
                    test=TestConfig(backend="torch", precision=FULL_FP32),
                    stream=StreamConfig(k_max=k_max),
                    raster=RasterConfig()).plan
    proj = jproject(scene, camera)
    ps = ProjectedScene(convert.projected_from_numpy(
        {f: np.asarray(getattr(proj, f)) for f in proj._fields}),
        plan.grid.make())
    ts = plan.stage1_compact(ps)[0]
    h = plan.ctu(ps, ts)
    return kops.gather_tile_features(ps.proj, ps.grid, h.lists, h.valid,
                                     h.entry_mini_mask)


def prefix_breaks(alive, valid) -> set:
    """Tiles where, in some K_BLK chunk, `alive` is not `valid & (kk <= m)`
    for any prefix end m. alive, valid: (T, K) numpy bool."""
    bad = set()
    for c0 in range(0, alive.shape[1], render.K_BLK):
        a, v = alive[:, c0:c0 + render.K_BLK], valid[:, c0:c0 + render.K_BLK]
        kk = np.arange(a.shape[1])
        last = np.where(a.any(1), np.max(np.where(a, kk, -1), axis=1), -1)
        expect = v & (kk[None] <= last[:, None])
        bad |= set(np.nonzero((expect != a).any(1))[0].tolist())
    return bad


def closest_to_t_eps(operands, tile) -> float:
    """Min |T - T_EPS| over every entry the plain front-to-back fold of
    `tile` visits (where a reassociated transmittance may fall on the
    other side of T_EPS)."""
    pix, feat, _, valid, allow = (x[tile:tile + 1] for x in operands)
    mt = render.pixel_minitile_index(pix.shape[1], allow.shape[2])
    trans = torch.ones(pix.shape[:2])
    closest = float("inf")
    for k in range(feat.shape[1]):
        closest = min(closest, float((trans - T_EPS).abs().min()))
        lane = (valid[:, k, None] != 0) & (allow[:, k][:, mt] != 0)
        a = entry_alpha(pix, feat[:, k, 0:2], feat[:, k, 2:5], feat[:, k, 5],
                        lane)
        trans = trans * (1.0 - a)
    return closest


@pytest.mark.parametrize("scene_name", ["small_scene", "wall_scene"])
def test_entry_alive_is_a_prefix_of_each_chunk(request, cam64, scene_name):
    """The invariant the CUDA fused blend reports entry_alive by: within
    each K_BLK chunk the entries some pixel was alive for are the valid
    entries up to one prefix end (transmittance never grows). Exact for
    the plain fused blend; the reference's Pallas kernel may break it only
    at a T_EPS tie of its in-block cumprod."""
    operands = scene_blend_operands(request.getfixturevalue(scene_name),
                                    cam64)
    valid = operands[3].numpy() != 0
    assert operands[1].shape[1] <= 256 and valid.any()
    plain = render.blend_tiles_fused(*operands)
    alive = plain.entry_alive.numpy()
    assert alive.any()
    assert prefix_breaks(alive, valid) == set()
    want = jrender.blend_tiles_fused(*(jnp.asarray(x.numpy())
                                       for x in operands), interpret=True)
    for tile in prefix_breaks(np.asarray(want.entry_alive), valid):
        assert closest_to_t_eps(operands, tile) <= 1e-6, tile
    if scene_name == "wall_scene":        # the prefix ends inside a chunk
        run = plain.kblocks_processed.numpy()
        assert (run < render.kblock_bound_of(operands[3]).numpy()).any()
        assert (valid & ~alive).any()


def test_leader_corners_lie_on_the_lattice():
    """K1 hoists Alg. 1's separable half onto the 4x4 leader lattice: the
    port's leader corners (those `ops.entry_cat_operands` hands the
    kernel) keep x fixed down each mini-tile column and y along each row,
    and equal the reference's tile-local leaders."""
    grid = TileGrid(64, 64)
    top, bot = leader_corners(grid)
    j = np.arange(16)
    for p in (top.numpy(), bot.numpy()):
        np.testing.assert_array_equal(p[:, 0], p[j % 4, 0])
        np.testing.assert_array_equal(p[:, 1], p[4 * (j // 4), 1])
    assert len(np.unique(top.numpy()[:, 0])) == 4
    assert len(np.unique(bot.numpy()[:, 1])) == 4
    jgrid = JGrid(64, 64)
    local = np.asarray(jgrid.minitile_local_origins(), np.float32)
    m = float(jgrid.minitile - 1)
    np.testing.assert_array_equal(top.numpy(), local + 0.5)
    np.testing.assert_array_equal(bot.numpy(), local + (m + 0.5))
