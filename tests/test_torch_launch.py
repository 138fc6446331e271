"""The port's serving driver (`python -m repro_torch.launch.serve`) and its
one-device mesh (`repro_torch.launch.mesh`), on the CPU.

The reference's own driver tests (`test_system.py::test_serve_driver_*`)
fail on this tree, so the port's driver is held against the port's
library path, which `test_torch_serving.py` and `test_torch_lm.py` hold
against the reference:

  render mode   `--device cpu --frames 4 --res 32 --gaussians 200`, with
                and without `--pallas`: rc 0, and every served frame
                (image, alpha, counters) bit-equal to a fresh engine of
                the same configuration serving that request alone
  lm mode       `--device cpu --arch qwen1.5-0.5b --reduced --batch 1
                --prefill 32 --decode 3`: rc 0, and the decoded tokens
                equal greedy decoding through `Model` from the same seed;
                llava (embeddings input) runs too
  families      `--reduced` deepseek (MoE with MLA), mamba2 (SSM), zamba2
                (hybrid) and seamless (enc-dec, the reference's prompt):
                rc 0, tokens equal to greedy decoding through `Model`
  refusals      a mesh of two devices (exit 2) and `--device cuda`
                without a CUDA device exit non-zero with a message;
                `Model` refuses a 2-device mesh
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.distributed.sharding import Mesh
from repro_torch.launch import serve
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import Model
from repro_torch.serving import RenderRequest


def capture(monkeypatch, name: str) -> dict:
    """Wrap `serve.<name>` so that its result is kept in the returned
    dict under "out" when `serve.main` runs it."""
    seen = {}
    fn = getattr(serve, name)

    def wrapped(*args, **kwargs):
        seen["out"] = fn(*args, **kwargs)
        return seen["out"]

    monkeypatch.setattr(serve, name, wrapped)
    return seen


@pytest.mark.parametrize("pallas", [False, True])
def test_render_driver_frames_equal_engine(monkeypatch, pallas):
    argv = ["--mode", "render", "--device", "cpu", "--frames", "4",
            "--res", "32", "--gaussians", "200"] + (["--pallas"] * pallas)
    seen = capture(monkeypatch, "run_render")
    assert serve.main(argv) == 0
    out = seen["out"]
    results = out["results"]
    assert len(results) == 4 and sum(w["requests"] for w in out["waves"]) == 4
    assert out["engine"].plan.test.backend == ("cuda" if pallas else "torch")
    engine = serve.render_engine(serve.parser().parse_args(argv))
    for r in results:
        req = r.frame.request
        alone, = engine.render_batch([RenderRequest(req.scene, req.camera)])
        assert alone.batch_size == 1
        assert torch.equal(r.image, alone.image)
        assert torch.equal(r.frame.alpha, alone.alpha)
        assert r.counters.keys() == alone.counters.keys()
        for k in alone.counters:
            assert torch.equal(r.counters[k], alone.counters[k]), k
    # The waves of 1, 2 and 1 requests batched frames together.
    assert max(r.frame.batch_size for r in results) == 2


def test_lm_driver_tokens_equal_library(monkeypatch):
    argv = ["--mode", "lm", "--device", "cpu", "--arch", "qwen1.5-0.5b",
            "--reduced", "--batch", "1", "--prefill", "32", "--decode", "3"]
    seen = capture(monkeypatch, "run_lm")
    assert serve.main(argv) == 0
    out = seen["out"]
    assert out["tokens"].shape == (1, 3)
    assert len(out["step_ms"]) == 3 and out["prefill_ms"] > 0

    m = Model(reduced(get_arch("qwen1.5-0.5b")), device="cpu", seed=0)
    logits, _ = m.prefill(dict(tokens=torch.ones((1, 32), dtype=torch.long)))
    caches = m.init_caches(1, 35)
    tok, toks = torch.argmax(logits, -1)[:, None], []
    for _ in range(3):
        lg, caches = m.decode_step(caches, tok)
        tok = torch.argmax(lg, -1)[:, None]
        toks.append(tok)
    assert torch.equal(out["tokens"], torch.cat(toks, 1))
    assert caches["pos"] == 3

    assert serve.main(["--mode", "lm", "--device", "cpu", "--arch",
                       "llava-next-mistral-7b", "--reduced", "--batch", "2",
                       "--prefill", "16", "--decode", "2"]) == 0
    assert seen["out"]["tokens"].shape == (2, 2)


def greedy(m, batch: dict, decode: int):
    """The library path of `serve.run_lm`: prefill, then greedy decode
    from fresh caches sized prompt + decode."""
    logits, _ = m.prefill(batch)
    b, s = batch["tokens" if "tokens" in batch else "embeds"].shape[:2]
    caches = m.init_caches(b, s + decode)
    tok, toks = torch.argmax(logits, -1)[:, None], []
    for _ in range(decode):
        lg, caches = m.decode_step(caches, tok)
        tok = torch.argmax(lg, -1)[:, None]
        toks.append(tok)
    return torch.cat(toks, 1)


def test_lm_driver_refuses_unported_family(monkeypatch, capsys):
    """Every family is served now: the driver's LM mode serves one reduced
    arch of each new family (MoE with MLA, SSM, hybrid, enc-dec with the
    reference's prompt of zero encoder frames and decoder tokens of 1),
    each decoding the library path's greedy tokens; deepseek with its
    parameters held in bf16 (`--param-dtype bfloat16`, as it is served at
    full width). What it still refuses is a mesh larger than one device
    (exit 2, saying so)."""
    seen = capture(monkeypatch, "run_lm")
    for arch, extra in (("deepseek-v2-lite-16b", {"param_dtype": "bfloat16"}),
                        ("mamba2-780m", {}), ("zamba2-1.2b", {}),
                        ("seamless-m4t-large-v2", {})):
        flags = [f"--{k.replace('_', '-')}={v}" for k, v in extra.items()]
        assert serve.main(["--mode", "lm", "--device", "cpu", "--arch", arch,
                           "--reduced", "--batch", "2", "--prefill", "32",
                           "--decode", "3"] + flags) == 0, arch
        cfg = dataclasses.replace(reduced(get_arch(arch)), **extra)
        dtypes = {p.dtype for p in seen["out"]["model"].parameters()}
        assert dtypes == {torch.bfloat16 if extra else torch.float32}, arch
        batch = serve.lm_batch(cfg, 2, 32, "cpu")
        if cfg.family == "encdec":
            assert batch.keys() == {"enc_embeds", "tokens"}
            assert not batch["enc_embeds"].any()
            assert batch["enc_embeds"].dtype == torch.bfloat16
            assert bool((batch["tokens"] == 1).all())
        want = greedy(Model(cfg, device="cpu", seed=0), batch, 3)
        assert torch.equal(seen["out"]["tokens"], want), arch
    capsys.readouterr()
    monkeypatch.setattr(serve, "make_local_mesh",
                        lambda dev: Mesh([dev, dev]))
    assert serve.main(["--mode", "lm", "--device", "cpu", "--arch",
                       "zamba2-1.2b", "--reduced"]) == 2
    err = capsys.readouterr().err
    assert "one-device mesh" in err and "sharding" in err


def test_driver_refuses_missing_cuda(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mode in ("render", "lm"):
        assert serve.main(["--mode", mode]) != 0
        err = capsys.readouterr().err
        assert "--device cuda" in err and "is_available() is False" in err
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(reduced(get_arch("qwen1.5-0.5b")))


def test_local_mesh_and_model_mesh_rule():
    mesh = make_local_mesh("cpu")
    assert mesh.axis_names == ("data", "model")
    assert mesh.shape == {"data": 1, "model": 1}
    assert mesh.primary == torch.device("cpu")
    cfg = reduced(get_arch("qwen1.5-0.5b"))
    m = Model(cfg, mesh=mesh)
    assert m.device == torch.device("cpu")
    hybrid = reduced(get_arch("zamba2-1.2b"))
    for devices in ([["cpu"], ["cpu"]], ["cpu", "cpu"]):
        with pytest.raises(NotImplementedError, match="sharding"):
            Model(hybrid, mesh=Mesh(devices))
        assert Model(cfg, mesh=Mesh(devices)).device == torch.device("cpu")
