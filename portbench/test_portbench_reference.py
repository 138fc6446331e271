"""The plain reference against the port on the CPU, its control, and the
work counts behind the rooflines. Small frames (64 x 48, 1024 Gaussians)
so that the folder's tests stay within seconds; no card, no nvcc."""
from __future__ import annotations

import dataclasses

import pytest
import torch

from portbench import harness, inputs, judge, manifest
from portbench.reference import render as reference

ROOT = harness.ROOT
BENCH = manifest.load_benchmark(ROOT)
CONFIGS = [c["name"] for c in BENCH["configs"]]
W, H, N = 64, 48, 1024


def _small(config_name: str) -> dict:
    import json
    file = next(c["file"] for c in BENCH["configs"]
                if c["name"] == config_name)
    cfg = json.loads((ROOT / file).read_text())
    return dict(cfg, width=W, height=H, gaussians=N)


def _port_plan(k_max: int, passes: int):
    """The configurations' plan (`hd1080_plan`) with every stage on its
    plain PyTorch version, at the small frame."""
    from repro_torch.core.renderer import RasterConfig
    from repro_torch.serving import workloads
    plan = workloads.hd1080_plan(k_max)
    return dataclasses.replace(
        plan, grid=plan.grid.with_resolution(H, W),
        test=dataclasses.replace(plan.test, backend="torch"),
        raster=RasterConfig(fused=False),
        stream=dataclasses.replace(plan.stream, max_spill_passes=passes))


def _frames(cfg: dict, seed: int, thetas):
    """(scene dict, [(port camera, reference camera), ...])."""
    from repro_torch.core.camera import Camera
    scene = inputs.scene_from_config(cfg, seed, "cpu")
    poses = inputs.config_poses(cfg, thetas, "cpu")
    cams = []
    for i in range(len(thetas)):
        port = Camera(R_wc=poses["R"][i], t_wc=poses["t"][i],
                      fx=torch.tensor(poses["fx"]),
                      fy=torch.tensor(poses["fy"]),
                      cx=torch.tensor(poses["cx"]),
                      cy=torch.tensor(poses["cy"]), width=W, height=H)
        cams.append((port, harness.reference_camera((poses, i))))
    return scene, cams


@pytest.mark.parametrize("config", CONFIGS)
def test_stated_test_is_the_plans(config):
    """The mini-tile test a configuration states to the reference is the
    one its plan runs."""
    from repro_torch.serving import workloads
    cfg = _small(config)
    plan = getattr(workloads, cfg["plan"])(cfg["k_max_pass"])
    cat = harness.reference_cat(cfg)
    assert cfg["test"]["method"] == plan.test.method == "cat"
    assert cat.mode == plan.test.mode.value
    prec = plan.test.precision
    assert (cat.coord, cat.delta, cat.mul, cat.acc, cat.slack) == (
        prec.coord, prec.delta, prec.mul, prec.acc, prec.slack)
    assert reference.SPIKY_RATIO == plan.test.spiky_threshold


def test_reference_holds_the_ports_plain_plan():
    """Each frame of the all-"torch" plan is within every configuration's
    limits of the reference, and within 2e-4: the port keeps blending a
    pixel after its transmittance fell below 1e-4 while some pixel of its
    tile lives, the reference stops it, so they part by less than 1e-4 of
    a channel, plus rounding. The TF32 control, at the same frames, fails
    one of the limits. (The configurations state the same scene
    distribution and mini-tile test; only their sizes differ.)"""
    from repro_torch.core.gaussians import GaussianScene
    cfg = _small("hd1080")
    cat = harness.reference_cat(cfg)
    plan = _port_plan(64, 8)
    gaps, control = [], []
    for seed in (3, 4):
        scene, cams = _frames(cfg, seed, [0.4 + seed, 2.5 + seed])
        for port_cam, ref_cam in cams:
            out, _ = plan.render_with_stats(GaussianScene(**scene), port_cam)
            assert not bool(out.overflow)
            ref, _ = reference.render(scene, ref_cam, cat)
            low, _ = reference.render(scene, ref_cam, cat, "tf32")
            gaps.append(judge.frame_gaps(out.image, ref))
            control.append(judge.frame_gaps(low, ref))
    numbers = judge.combine(gaps)
    assert numbers["max_abs"] <= 2e-4, numbers
    for name in CONFIGS:
        limits = _small(name)["limits"]
        assert judge.judge(numbers, limits)[0], (name, numbers)
        assert not judge.judge(judge.combine(control), limits)[0], name


def test_counts_do_not_depend_on_the_plan():
    """The work counts come from the scene and the camera alone: two plans
    that split the same frame's lists differently (64 x 8 passes, 512 x 1)
    render it bit for bit alike, and the reference's counts, the same for
    any blocking of its own, never exceed the work either plan did."""
    from repro_torch.core.gaussians import GaussianScene
    cfg = _small("hd1080")
    cat = harness.reference_cat(cfg)
    scene, cams = _frames(cfg, 5, [1.0])
    port_cam, ref_cam = cams[0]
    _, counts = reference.render(scene, ref_cam, cat)
    _, again = reference.render(scene, ref_cam, cat, block_elems=1 << 16)
    assert counts == again
    assert 0 < counts.entries_blended <= counts.pairs
    images = []
    for k_max, passes in ((64, 8), (512, 1)):
        out, _ = _port_plan(k_max, passes).render_with_stats(
            GaussianScene(**scene), port_cam)
        images.append(out.image)
        assert counts.pairs <= int(out.entry_alive.sum())
        assert counts.lanes <= int(out.processed_per_pixel.sum())
    assert torch.equal(images[0], images[1])


def test_tf32_rounding():
    x = torch.tensor([1.0, 1 + 2.0 ** -10, 1 + 2.0 ** -11,
                      1 + 3 * 2.0 ** -11, -(1 + 3 * 2.0 ** -11), 0.0])
    want = torch.tensor([1.0, 1 + 2.0 ** -10, 1.0, 1 + 2.0 ** -9,
                         -(1 + 2.0 ** -9), 0.0])
    assert torch.equal(reference.round_tf32(x), want)
