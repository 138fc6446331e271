"""The port's kernel wrappers against the reference's Pallas kernels.

On the CPU each wrapper runs its kernel's plain PyTorch version; the
reference runs its Pallas kernel in interpret mode (K <= 256). Tolerances:

  K1 (entry CAT)      FULL_FP32 exact (every sampling mode), MIXED flip
                      rate < 5e-4
  K2 (fused blend)    rgb/trans atol 2e-4, counters exact, also when the
                      list is split into two chained passes
  fused-blend oracle  counters exact, rgb/trans atol 2e-4

The CUDA kernels themselves are held against these plain versions on the
card by `test_torch_cuda.py`, which also holds the seeded operand builders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import prtu as jprtu
from repro.kernels import ref as jref
from repro.kernels import render as jrender

from repro_torch.core.precision import (FULL_FP32, MIXED, FULL_FP8,
                                        PrecisionScheme)
from repro_torch.kernels import build, prtu, ref, render

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
