"""A whole run of a cell on the CPU, past the harness's look for a card, at
a small size: sound, it comes out correct; with the timed path broken
underneath it, once for each fault the cells can have, it does not. No
card, no nvcc: the port's kernels run their plain versions."""
from __future__ import annotations

import dataclasses
import time

import pytest

from portbench import harness, manifest

ROOT = harness.ROOT


def _small_cell(name: str, **mix) -> manifest.Cell:
    cell = manifest.cell(ROOT, name)
    cfg = dict(cell.config, width=48, height=32, gaussians=512,
               probe_poses=2, k_max_pass=64)
    return dataclasses.replace(cell, config=cfg,
                               traffic=dict(cell.traffic, **mix))


def _run(cell: manifest.Cell, monkeypatch) -> dict:
    monkeypatch.setattr(harness, "SAMPLE_FRAMES", 64)   # compare them all
    result, _ = harness.run(cell, 2 ** 31 + 99, 0.25, False, "cpu",
                            time.perf_counter())
    return result


def _alter(image):
    """A frame with one tile changed by 0.01: an answer altered where it
    is produced."""
    image = image.clone()
    image[:16, :16] += 0.01
    return image


def _faulty_batch(fault: str):
    from repro_torch.serving.engine import RenderEngine
    render_batch = RenderEngine.render_batch

    def broken(self, requests):
        frames = render_batch(self, requests)
        if fault == "altered":
            return [dataclasses.replace(f, image=_alter(f.image))
                    for f in frames]
        # half of the batch left out: its frames repeat the first half's
        half = max(1, len(frames) // 2)
        return [dataclasses.replace(f, image=frames[i % half].image)
                for i, f in enumerate(frames)]
    return broken


@pytest.mark.parametrize("fault", [None, "altered", "half"])
def test_batched_cell(fault, monkeypatch):
    from repro_torch.serving.engine import RenderEngine
    cell = _small_cell("hd1080.fresh-2c")
    if fault is not None:
        monkeypatch.setattr(RenderEngine, "render_batch",
                            _faulty_batch(fault))
    result = _run(cell, monkeypatch)
    assert result["correct"] is (fault is None), result["checks"]
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("fault", [None, "stale"])
def test_session_cell(fault, monkeypatch):
    """A session whose state never advances serves its first frame again
    (the walk is sped up to 1/64 turn a frame, so that frames differ)."""
    from repro_torch.serving.engine import RenderEngine
    cell = _small_cell("hd1080.drift-2s", step_turns=1 / 64)
    if fault == "stale":
        one = RenderEngine._render_incremental_one
        first = {}

        def stale(self, request, *args):
            frame = one(self, request, *args)
            return dataclasses.replace(
                frame, image=first.setdefault(request.session, frame.image))
        monkeypatch.setattr(RenderEngine, "_render_incremental_one", stale)
    result = _run(cell, monkeypatch)
    assert result["correct"] is (fault is None), result["checks"]
