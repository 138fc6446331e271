"""The port's dry-runs, roofline, collective counter, compression over a
mesh and profiler hook, against the JAX reference on the CPU.

- `launch.roofline`: `model_flops` equals the reference's for every arch
  x shape; `analyze`'s terms times each package's own rate are the same
  counts, and with the port's rates set to the reference's its
  bottleneck is the reference's.
- `sharding.counting`: the closed-form bytes and op counts of each
  collective on a (2, 2) mesh of CPU devices, a result shared by the
  positions of one device counted per position, nothing outside the
  context.
- `launch.dryrun.run_cell` on meta equals the same counters around a real
  CPU step (reduced qwen, (2, 2)); per family (dense, MoE with MLA, SSM,
  hybrid, enc-dec) the depth-extrapolated counts equal a whole-depth meta
  run exactly, and `argument_bytes` equals a sum over
  `NamedSharding.local_shape` computed here.
- `launch.render_dryrun` on four CPU rows: each frame bit-equal to the
  port's per-frame render and within 2e-4 of the reference's
  `RenderPlan.render_with_stats`, `processed_per_pixel` equal.
- `optim.compression` over a mesh: bit-equal to the reference's
  `apply_tree` on the whole gradient, topk and int8, on (2, 2) and on
  (pod=2, data=2, model=2) with replicated blocks; three driver steps
  with `--compress topk` over (2, 2) against one device.
- `obs.torch_profiler_trace`: a Chrome trace with CPU events; a no-op
  when disabled.

The file holds few tests, each looping over its cases: the tier-1 run
queues files by test count, and a file of few tests stays out of the
way of the long ones.
"""
import dataclasses
import json
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as RARCHS, SHAPES as RSHAPES
from repro.core import random_scene as jrandom_scene
from repro.core.camera import Camera as JCamera
from repro.core.cat import SamplingMode as JMode
from repro.core.precision import FULL_FP32 as J_FP32
from repro.core.renderer import (GridConfig as JGrid, RenderPlan as JPlan,
                                 StreamConfig as JStream,
                                 TestConfig as JTest)
from repro.launch import roofline as RRL
from repro.optim import compression as RC

import repro_torch.configs as T
from repro_torch import convert
from repro_torch.checkpoint.ckpt import flatten
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import FULL_FP32
from repro_torch.data import tokens as data
from repro_torch.distributed import sharding as D
from repro_torch.launch import dryrun as DR
from repro_torch.launch import render_dryrun as RD
from repro_torch.launch import roofline as RL
from repro_torch.launch import steps as ST
from repro_torch.launch import train as TR
from repro_torch.models import pspec
from repro_torch.models.model import Model
from repro_torch.obs import torch_profiler_trace
from repro_torch.optim import adamw
from repro_torch.optim.compression import (CompressionConfig, apply_tree,
                                           compress_decompress)

CPU = torch.device("cpu")
META = torch.device("meta")


def mesh_of(shape, dev=CPU, names=("data", "model")) -> D.Mesh:
    flat = [dev] * math.prod(shape)
    for n in reversed(shape[1:]):
        flat = [flat[i:i + n] for i in range(0, len(flat), n)]
    return D.Mesh(flat, names)


def test_roofline_matches_reference():
    """model_flops for every arch x shape; one cell's terms and
    bottleneck."""
    for name, cfg in T.ARCHS.items():
        for sname, shape in T.SHAPES.items():
            assert RL.model_flops(cfg, shape) == RRL.model_flops(
                RARCHS[name], RSHAPES[sname]), (name, sname)
    cell = dict(devices=256, flops=3.1e14, bytes_accessed=2.2e12,
                collectives=dict(total_bytes=9.0e10))
    for name, sname in (("qwen1.5-0.5b", "train_4k"),
                        ("arctic-480b", "decode_32k")):
        a = RL.analyze(cell, T.ARCHS[name], T.SHAPES[sname])
        r = RRL.analyze(cell, RARCHS[name], RSHAPES[sname])
        assert a["t_compute"] * RL.PEAK_FLOPS == pytest.approx(
            r["t_compute"] * RRL.PEAK_FLOPS, rel=1e-15)
        assert a["t_memory"] * RL.HBM_BW == pytest.approx(
            r["t_memory"] * RRL.HBM_BW, rel=1e-15)
        assert a["t_collective"] * RL.LINK_BW == pytest.approx(
            r["t_collective"] * RRL.ICI_BW, rel=1e-15)
        assert a["model_flops"] == r["model_flops"]
        saved = RL.PEAK_FLOPS, RL.HBM_BW, RL.LINK_BW
        try:
            RL.PEAK_FLOPS, RL.HBM_BW, RL.LINK_BW = (
                RRL.PEAK_FLOPS, RRL.HBM_BW, RRL.ICI_BW)
            same = RL.analyze(cell, T.ARCHS[name], T.SHAPES[sname])
        finally:
            RL.PEAK_FLOPS, RL.HBM_BW, RL.LINK_BW = saved
        for k, v in r.items():
            assert same[k] == pytest.approx(v, rel=1e-15), k
    assert (RL.PEAK_FLOPS, RL.HBM_BW, RL.LINK_BW) == (989e12, 3.35e12, 50e9)


class Heard(D.CollectiveCounter):
    def __init__(self):
        super().__init__()
        self.heard = []

    def shared(self, tensor, k):
        self.heard.append((tuple(tensor.shape), k))


def test_collective_counter_closed_form():
    """Each collective's (kind, bytes of one position's result,
    positions) on a (2, 2) CPU mesh; the results that positions of one
    device share are heard once with their count; the per-device sums;
    nothing recorded outside the context."""
    mesh = mesh_of((2, 2))
    x = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    pieces = [x[:4], x[4:]]
    devs = [CPU, CPU]
    with D.counting(Heard()) as c:
        ag = D.all_gather(pieces, 0, devs)
        ar = D.all_reduce(pieces, devs)
        rs = D.reduce_scatter([x, x], 1, devs)
        sh = D.named(mesh, ("fsdp", "model"))
        g = D.gather_over(D.shard(x, sh), sh, ("data",))
        D.gather_over(D.shard(x, D.named(mesh, (None, "model"))),
                      D.named(mesh, (None, "model")), ("data",))
    assert torch.equal(ag[0], x) and ag[0] is ag[1]
    assert torch.equal(ar[0], pieces[0] + pieces[1])
    assert torch.equal(rs[1], 2 * x[:, 4:])
    assert torch.equal(g[0], x[:, :4]) and g[0] is g[2]
    assert c.records == [("all-gather", 256, 2), ("all-reduce", 128, 2),
                         ("reduce-scatter", 128, 2), ("all-gather", 128, 4)]
    assert c.heard == [((8, 8), 2), ((4, 8), 2), ((8, 4), 2), ((8, 4), 2)]
    cb = RL.collective_bytes(c.records, devices=4)
    assert cb == dict(total_bytes=(512 + 256 + 256 + 512) / 4,
                      per_kind={"all-gather": 1024 / 4,
                                "all-reduce": 64.0,
                                "reduce-scatter": 64.0},
                      num_ops=10 / 4)
    D.all_gather(pieces, 0, devs)
    assert len(c.records) == 4
    # Two distinct devices' positions: a result each, none shared.
    with D.counting(Heard()) as c2:
        out = D.all_gather(pieces, 0, [CPU, META])
    assert out[1].device == META and c2.heard == []
    assert c2.records == [("all-gather", 256, 2)]


SMALL_TRAIN = ShapeConfig("t", "train", 32, 4)


def local_sum(leaves_and_shardings) -> int:
    """Σ prod(local_shape) · itemsize over (shape, dtype, sharding)."""
    total = 0
    for shape, dtype, sh in leaves_and_shardings:
        loc = sh.local_shape(shape) if len(shape) else ()
        total += math.prod(loc) * torch.empty((), dtype=dtype).element_size()
    return total


def test_run_cell_equals_a_real_cpu_step():
    """Reduced qwen, (2, 2), a train step: the meta cell's flops, bytes,
    collectives and temp bytes equal the same counters around the step
    on CPU devices; argument bytes are the placements' local sums."""
    cfg = T.reduced(T.get_arch("qwen1.5-0.5b"))
    cell = DR.run_cell(cfg, SMALL_TRAIN, mesh_of((2, 2), META), depths=None,
                       verbose=False)
    mesh = mesh_of((2, 2))
    model = Model(cfg, device="cpu", seed=0, mesh=mesh)
    step, example, args = DR.step_and_args(model, SMALL_TRAIN, mesh)
    real = DR.count_step(model, step, args)
    assert cell["flops"] * 4 == real["flops"] > 0
    assert cell["bytes_accessed"] * 4 == real["bytes_accessed"]
    assert cell["mem"]["temp_bytes"] * 4 == real["peak"] > 0
    want = RL.collective_bytes(real["records"], 4)
    assert cell["collectives"] == want and want["num_ops"] > 0
    assert set(want["per_kind"]) == {"all-gather", "all-reduce",
                                     "reduce-scatter", "collective-permute"}
    # Arguments: params, AdamW's m and v, the step, the batch.
    p_sh = pspec.shardings(model.specs(), mesh)
    params = [(p.shape, torch.float32, s) for (_, p), (_, s) in
              zip(pspec.leaves(model.specs()), pspec.leaves(p_sh))]
    b_sh = ST.batch_shardings(model, SMALL_TRAIN, mesh)
    batch = [(v.shape, v.dtype, b_sh[k])
             for k, v in model.input_specs(SMALL_TRAIN).items()]
    step0 = [((), torch.int32, D.NamedSharding(mesh, ()))]
    assert cell["mem"]["argument_bytes"] == local_sum(
        3 * params + step0 + batch) > 0
    assert cell["mem"]["peak_bytes"] == (cell["mem"]["temp_bytes"]
                                         + cell["mem"]["argument_bytes"])


def family_cfg(name: str):
    """A reduced arch deep enough for a fit: 4 layers a stacked group
    (the hybrid 4 groups of 2 and a tail of 1, the MoE 1 dense + 4)."""
    cfg = T.reduced(T.get_arch(name))
    if cfg.family == "hybrid":
        return dataclasses.replace(cfg, num_layers=9)
    if cfg.family == "moe":
        return DR.at_depth(cfg, dict(first=1, layers=4))
    return DR.at_depth(cfg, {g: 4 for g in DR.depth_groups(cfg)})


def test_depth_extrapolation_is_exact_for_every_family():
    """At cut depths (2, 3) the fit of every count equals the whole-depth
    meta run on a (1, 2) meta mesh: decode for dense qwen, a train step
    (remat) for mamba2, prefill for the others; argument bytes from the
    placements. (At cut depths (1, 2) the fit misses for qwen, zamba2
    and seamless, whose peaks still move between one and two layers.)"""
    mesh = mesh_of((1, 2), META)
    cases = (("qwen1.5-0.5b", ShapeConfig("d", "decode", 64, 4)),
             ("deepseek-v2-lite-16b", ShapeConfig("p", "prefill", 32, 4)),
             ("mamba2-780m", SMALL_TRAIN),
             ("zamba2-1.2b", ShapeConfig("p", "prefill", 32, 4)),
             ("seamless-m4t-large-v2", ShapeConfig("p", "prefill", 32, 4)))
    for name, shape in cases:
        cfg = family_cfg(name)
        fit = DR.run_cell(cfg, shape, mesh, depths=(2, 3), verbose=False)
        whole = DR.run_cell(cfg, shape, mesh, depths=None, verbose=False)
        assert len(fit["depths"]["runs"]) >= 2, name
        for k in ("flops", "bytes_accessed", "mem", "collectives"):
            assert fit[k] == whole[k], (name, k)
        model = Model(cfg, device=META, mesh=mesh)
        p_sh = pspec.shardings(model.specs(), mesh)
        pdt = torch.bfloat16 if cfg.param_dtype == "bfloat16" \
            else torch.float32
        params = [(p.shape, pdt, s) for (_, p), (_, s) in
                  zip(pspec.leaves(model.specs()), pspec.leaves(p_sh))]
        b_sh = ST.batch_shardings(model, shape, mesh)
        batch = [(v.shape, v.dtype, b_sh[k])
                 for k, v in model.input_specs(shape).items()]
        extra = []
        if shape.kind == "train":
            extra = 2 * params + [((), torch.int32,
                                   D.NamedSharding(mesh, ()))]
        if shape.kind == "decode":
            D.map_with(lambda x, sh: extra.append((x.shape, x.dtype, sh))
                       if torch.is_tensor(x) else None,
                       model.init_caches(4, 64, device=META),
                       ST.cache_shardings(model, 4, 64, mesh))
        assert whole["mem"]["argument_bytes"] == local_sum(
            params + extra + batch), name


def jax_scene(scene):
    from repro.core.gaussians import GaussianScene as JScene
    return JScene(**{f: jnp.asarray(getattr(scene, f).numpy())
                     for f in ("means", "log_scales", "quats",
                               "opacity_logits", "colors")})


def jax_camera(cam):
    return JCamera(**{f: jnp.asarray(getattr(cam, f).numpy())
                      for f in ("R_wc", "t_wc", "fx", "fy", "cx", "cy")},
                   width=cam.width, height=cam.height)


def test_render_dryrun_frames_match():
    """4 frames at 32², 200 Gaussians (the reference's scene), one a
    position on four CPU rows: bit-equal to the port's per-frame render,
    within 2e-4 of the reference's, processed_per_pixel equal; the
    per-position records. At FULL_FP32, not the dry-run's MIXED: the
    reference is jitted here (eager, its first frame takes 14 s to
    dispatch), and its jitted MIXED Alg. 1 flips CAT ties (fault F4,
    `test_torch_serving.py`), on one of these frames too."""
    jscene = jrandom_scene(jax.random.PRNGKey(3), 200)
    scene = convert.scene_from_numpy(
        {f.name: np.asarray(getattr(jscene, f.name))
         for f in dataclasses.fields(jscene)})
    _, cams = RD.make_inputs(4, 32, 1, CPU)
    plan = RD.make_plan(32, 256)
    plan = dataclasses.replace(plan, test=dataclasses.replace(
        plan.test, precision=FULL_FP32))
    mesh = D.Mesh([[CPU]] * 4)
    res = RD.run(plan, scene, cams, mesh, keep=range(4))
    jplan = JPlan(grid=JGrid(height=32, width=32),
                  test=JTest(method="cat", mode=JMode.SMOOTH_FOCUSED,
                             precision=J_FP32),
                  stream=JStream(k_max=256))
    jrender = jax.jit(jplan.render_with_stats)
    for i, cam in enumerate(cams):
        (img,), (ppp,) = res["kept"][i]
        out, counters = plan.render_with_stats(scene, cam)
        assert torch.equal(img, out.image)
        assert torch.equal(ppp, counters["processed_per_pixel"])
        jout, jc = jrender(jscene, jax_camera(cam))
        np.testing.assert_allclose(img.numpy(), np.asarray(jout.image),
                                   rtol=0, atol=2e-4)
        np.testing.assert_array_equal(
            ppp.numpy(), np.asarray(jc["processed_per_pixel"]))
    rows = res["positions"]
    assert len(rows) == 4 and res["frames_per_position"] == 1
    scene_b = sum(t.numel() * 4 for t in RD._scene_tensors(scene))
    for r in rows:
        assert r["collective_bytes"] == 0 and r["temp_bytes"] > 0
        assert r["argument_bytes"] == scene_b + 4 * (9 + 3 + 4)
        assert r["output_bytes"] == 32 * 32 * 3 * 4 + 4
        assert r["bytes_accessed"] > 0
    assert res["max"]["peak_bytes"] == max(
        r["temp_bytes"] + r["argument_bytes"] for r in rows)


def grad_tree(rng) -> dict:
    return dict(w=rng.standard_normal((8, 16)).astype(np.float32),
                e=rng.standard_normal((16, 4)).astype(np.float32),
                b=rng.standard_normal((16,)).astype(np.float32))


def test_compression_over_a_mesh_equals_the_reference():
    """Two rounds of `apply_tree` (residuals carried) on Sharded leaves
    equal the reference's on the whole gradient bit for bit, topk (at a
    fraction that keeps several entries, and with a tie) and int8, on
    (2, 2) and on (pod=2, data=2, model=2), where "e" and "b" replicate
    blocks."""
    rng = np.random.default_rng(0)
    meshes = ((mesh_of((2, 2)), dict(w=("fsdp", "model"),
                                     e=("model", None), b=(None,))),
              (mesh_of((2, 2, 2), names=("pod", "data", "model")),
               dict(w=("fsdp", "model"), e=(None, "model"), b=("model",))))
    for kind, frac in (("topk", 0.1), ("topk", 0.01), ("int8", 0.01)):
        cfg = CompressionConfig(kind=kind, topk_frac=frac)
        rcfg = RC.CompressionConfig(kind=kind, topk_frac=frac)
        for mesh, logical in meshes:
            grads = [grad_tree(rng) for _ in range(2)]
            grads[1]["w"][0, :2] = grads[1]["w"][0, 2]     # a tie
            shs = {k: D.named(mesh, v) for k, v in logical.items()}
            res = {k: D.Sharded.of(torch.zeros(v.shape), shs[k])
                   for k, v in grads[0].items()}
            jres = RC.init_residuals({k: jnp.asarray(v)
                                      for k, v in grads[0].items()})
            for g in grads:
                gs = {k: D.Sharded.of(torch.from_numpy(v), shs[k])
                      for k, v in g.items()}
                hat, res = apply_tree(gs, res, cfg)
                jhat, jres = RC.apply_tree({k: jnp.asarray(v)
                                            for k, v in g.items()},
                                           jres, rcfg)
                for k in g:
                    for got, want in ((hat[k], jhat[k]), (res[k], jres[k])):
                        assert got.sharding is shs[k]
                        np.testing.assert_array_equal(
                            got.gather().numpy(), np.asarray(want),
                            err_msg=f"{kind} {frac} {k}")
                        for grp in shs[k].replica_groups():
                            for i in grp[1:]:
                                assert torch.equal(got.pieces[i],
                                                   got.pieces[grp[0]])


def update_error(before, after, want_before, want_after, grad, lr,
                 skip) -> float:
    """The worst |Δ update| / lr past two float32 ulps, over the entries
    whose gradient exceeds 1e-2 of its leaf's largest, less `skip`."""
    worst = 0.0
    for k, g in grad.items():
        sel = (g.abs() > 1e-2 * g.abs().max()) & ~skip[k]
        d = ((after[k] - before[k]) - (want_after[k] - want_before[k])).abs()
        mag = after[k].abs()
        ulp = torch.nextafter(mag, torch.full_like(mag, math.inf)) - mag
        err = (d - 2 * ulp)[sel]
        if err.numel():
            worst = max(worst, float(err.max()) / lr)
    return worst


def test_driver_compress_topk_over_a_mesh(tmp_path):
    """Three `launch.train` steps with --compress topk, reduced float32
    qwen with each attention input projection scaled to a fan-in draw,
    over (2, 2) and on one device from the same weights: loss and grad
    norm within 1e-5 relative, updates within 1e-3 lr past two ulps,
    replicas bit-equal; the mesh's compressed gradient equals the
    one-device scheme on its own gathered gradient bit for bit; the top-k
    masks differ only where |g| lies within 1e-5 relative of the
    threshold (counted: none here; at full width on the card float32
    sums in two orders part single entries by up to 3e-3, `PERF.md`).
    `launch.train.run` with --compress int8 takes two steps on the
    (2, 2) model."""
    cfg = dataclasses.replace(T.reduced(T.get_arch("qwen1.5-0.5b")),
                              dtype="float32")
    args = TR.parser().parse_args(["--arch", cfg.name, "--batch", "4",
                                   "--seq", "32", "--steps", "3",
                                   "--compress", "topk", "--device", "cpu"])
    opt_cfg = TR.opt_config(args, cfg)
    comp = CompressionConfig(kind="topk")
    mesh = mesh_of((2, 2))
    one = Model(cfg, device="cpu", seed=0)
    sh = Model(cfg, device="cpu", seed=0, mesh=mesh)
    seen = []

    def spy(grads, residuals, c):
        out = apply_tree(grads, residuals, c)
        seen.append((grads, residuals, out[0]))
        return out
    steps = [TR.make_step(m, opt_cfg, comp) for m in (one, sh)]
    states = [adamw.init(m.params(), opt_cfg) for m in (one, sh)]
    saved, TR.apply_tree = TR.apply_tree, spy
    shape = ShapeConfig("custom", "train", 32, 4)
    near = 0
    try:
        for i in range(3):
            batch = data.synthetic_batch(cfg, shape, i)
            before = [{k: v.clone() for k, v in m.state_dict().items()}
                      for m in (one, sh)]
            m_prev = {k: v.clone() for k, v in pspec.leaves(states[0].m)}
            mets = []
            for j in range(2):
                states[j], met = steps[j](states[j], batch)
                mets.append({k: float(v) for k, v in met.items()})
            for k in ("loss", "grad_norm"):
                assert abs(mets[1][k] - mets[0][k]) <= 1e-5 * abs(
                    mets[0][k]), (i, k)
            (g1, r1, h1), (g2, r2, h2) = seen[2 * i:2 * i + 2]
            for (_, g), (_, r), (_, h) in zip(pspec.leaves(g2),
                                              pspec.leaves(r2),
                                              pspec.leaves(h2)):
                want = compress_decompress(g.gather(), r.gather(), comp)[0]
                assert torch.equal(h.gather(), want)
            skip = {}
            for (k, a), (_, b), (_, ra), (_, rb), (_, ha), (_, hb) in zip(
                    pspec.leaves(g1), pspec.leaves(g2), pspec.leaves(r1),
                    pspec.leaves(r2), pspec.leaves(h1), pspec.leaves(h2)):
                ga = a.float() + ra
                gb = b.gather().float() + rb.gather()
                ka = max(1, int(ga.numel() * comp.topk_frac))
                th = torch.topk(ga.abs().reshape(-1), ka).values[-1]
                diff = (ha != 0) != (hb.gather() != 0)
                tie = (ga.abs() - th).abs() <= 1e-5 * th
                assert not (diff & ~tie).any(), (i, k)
                near += int(diff.sum())
                skip[k] = diff
            grad = {k: (v - opt_cfg.b1 * m_prev[k]) / (1 - opt_cfg.b1)
                    for k, v in pspec.leaves(states[0].m)}
            err = update_error(before[1], sh.state_dict(), before[0],
                               one.state_dict(), grad, mets[0]["lr"], skip)
            assert err <= 1e-3, (i, err)
            for t in flatten(sh.params()) + flatten(states[1]):
                if isinstance(t, D.Sharded):
                    for grp in t.sharding.replica_groups():
                        for g in grp[1:]:
                            assert torch.equal(t.pieces[g],
                                               t.pieces[grp[0]])
    finally:
        TR.apply_tree = saved
    assert near == 0
    args = TR.parser().parse_args([
        "--arch", cfg.name, "--batch", "4", "--seq", "32", "--steps", "2",
        "--compress", "int8", "--device", "cpu", "--ckpt-dir",
        str(tmp_path / "ck")])
    out = TR.run(args, log=lambda m: None, model=sh)
    assert len(out["metrics"]) == 2 and all(
        math.isfinite(m["loss"]) for m in out["metrics"])


def test_torch_profiler_trace_and_imports(tmp_path):
    """A Chrome trace with CPU events under the log directory; disabled,
    nothing is written. The render dry-run's default device exits 2
    without a card, and no module of this slice imports jax or the
    reference."""
    with torch_profiler_trace(tmp_path / "prof") as h:
        x = torch.randn(64, 64)
        (x @ x).sum()
    events = json.loads(pathlib.Path(h.path).read_text())["traceEvents"]
    assert h.written and any(e.get("name") == "aten::mm" for e in events)
    with torch_profiler_trace(tmp_path / "off", enabled=False) as h:
        pass
    assert h is None and not (tmp_path / "off").exists()
    assert RD.main(["--frames", "1"]) == (0 if torch.cuda.is_available()
                                          else 2)
    root = pathlib.Path(__file__).resolve().parents[1] / "src/repro_torch"
    for f in ("launch/dryrun.py", "launch/render_dryrun.py",
              "launch/roofline.py", "obs/export.py",
              "optim/compression.py", "distributed/sharding.py"):
        for line in (root / f).read_text().splitlines():
            words = line.split()
            assert not (words[:1] in (["import"], ["from"]) and any(
                w.split(".")[0] in ("jax", "jaxlib", "repro")
                for w in words[1:2])), (f, line)
