"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `cuda` and skips where torch has no CUDA device.
The file imports neither jax nor the reference package, so it also runs on
a GPU machine without them:

    PYTHONPATH=src python -m pytest -q --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: K1 (entry CAT) FULL_FP32 exact, MIXED flip rate < 5e-4; K2
(fused blend) rgb/trans atol 2e-4, counters exact; K4 (dense CAT) exact
under FULL_FP32 and MIXED; K3 (full-sweep blend) rgb/trans atol 1e-6. The
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

from repro_torch.core.precision import FULL_FP32, MIXED
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


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("prec", ["fp32", "mixed"])
def test_entry_cat_kernel_matches_plain(cuda, prec):
    p = {"fp32": FULL_FP32, "mixed": MIXED}[prec]
    ops = [torch.from_numpy(x) for x in cat_operands(3, t=64, k=512)]
    kw = dict(mode="smooth_focused", **prec_kw(p))
    want = prtu.prtu_entry_cat_mask(*ops, **kw)
    before = prtu.launches
    got = prtu.prtu_entry_cat_mask(*(x.to(cuda) for x in ops), **kw)
    assert prtu.launches == before + 1
    flips = int((got.cpu() != want).sum())
    assert flips == 0 if prec == "fp32" else flips < 5e-4 * want.numel()


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
