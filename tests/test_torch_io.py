"""The port's PLY import/export (`repro_torch.core.io`) against the JAX
reference's `core.io`.

A scene written by the port's `save_ply` and read back is exact in means,
log_scales, quats and opacity and within 1e-6 in colors (the SH_C0 affine
map), as in the reference's contract; the port writes the same bytes as
the reference for the same scene, and each package reads the other's file
bit for bit. The loader tolerates comment lines, f_rest_* properties and
missing normals, and refuses the four kinds of file the reference refuses
with the reference's messages.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import SH_C0 as J_SH_C0, load_ply as jload_ply
from repro.core import random_scene as jrandom_scene, save_ply as jsave_ply
from repro.core.io import _FIELDS as J_FIELDS

import repro_torch
from repro_torch import convert
from repro_torch.core import SH_C0, load_ply, save_ply
from repro_torch.core.io import _FIELDS

SCENE_FIELDS = ("means", "log_scales", "quats", "opacity_logits", "colors")


def fields(obj) -> dict:
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def ref_scene(n=257):
    # odd n on purpose: no pow2 padding hides indexing mistakes
    scene = jrandom_scene(jax.random.PRNGKey(3), n, scale_range=(-2.5, -1.0),
                          opacity_range=(-4.0, 4.0))
    return scene, convert.scene_from_numpy(fields(scene))


def write_ply(path, props, n, body, header_extra=(), fmt=None):
    lines = ["ply", fmt or "format binary_little_endian 1.0"]
    lines += list(header_extra)
    lines += [f"element vertex {n}"]
    lines += [f"property {t} {p}" for t, p in props]
    lines += ["end_header", ""]
    with open(path, "wb") as fh:
        fh.write("\n".join(lines).encode("ascii"))
        fh.write(body)


def test_constants_and_exports_match_reference():
    assert SH_C0 == J_SH_C0
    assert _FIELDS == J_FIELDS
    assert repro_torch.load_ply is load_ply
    assert repro_torch.save_ply is save_ply
    assert repro_torch.SH_C0 == SH_C0


def test_round_trip_exact(tmp_path):
    _, scene = ref_scene()
    path = tmp_path / "scene.ply"
    save_ply(scene, path)
    back = load_ply(path, device="cpu")
    assert back.n == scene.n
    for f in SCENE_FIELDS[:4]:
        assert torch.equal(getattr(back, f), getattr(scene, f)), f
        assert getattr(back, f).dtype == torch.float32
    np.testing.assert_allclose(back.colors.numpy(), scene.colors.numpy(),
                               rtol=0, atol=1e-6)


def test_saved_file_byte_identical_to_reference(tmp_path):
    """The same scene through each package's save_ply: the same bytes,
    header and body, for an odd count and for an empty scene."""
    for n in (257, 8, 0):
        jscene, scene = ref_scene(max(n, 1))
        if n == 0:
            jscene = jax.tree.map(lambda x: x[:0], jscene)
            scene = convert.scene_from_numpy(fields(jscene))
        save_ply(scene, tmp_path / "port.ply")
        jsave_ply(jscene, tmp_path / "ref.ply")
        raw = (tmp_path / "port.ply").read_bytes()
        assert raw == (tmp_path / "ref.ply").read_bytes(), n
        header = raw[:raw.index(b"end_header")].decode("ascii")
        assert header.startswith("ply\nformat binary_little_endian 1.0\n")
        assert f"element vertex {n}" in header
        body = raw[raw.index(b"end_header") + len("end_header\n"):]
        assert len(body) == n * 4 * len(_FIELDS)


def test_each_package_loads_the_others_file(tmp_path):
    """Port-written files load in the reference and reference-written files
    in the port, every field bit-equal to the same package's own load."""
    jscene, scene = ref_scene()
    save_ply(scene, tmp_path / "port.ply")
    jsave_ply(jscene, tmp_path / "ref.ply")
    for path in (tmp_path / "port.ply", tmp_path / "ref.ply"):
        got = load_ply(path, device="cpu")
        want = jload_ply(path)
        for f in SCENE_FIELDS:
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f)),
                                          err_msg=f"{path.name} {f}")


def test_load_tolerates_comments_and_f_rest(tmp_path):
    """An INRIA-style checkpoint: comment lines and 9 f_rest_* properties
    interleaved before opacity — the extras parse and drop, as in the
    reference."""
    props = _FIELDS[:9] + [f"f_rest_{i}" for i in range(9)] + _FIELDS[9:]
    n = 5
    rng = np.random.default_rng(0)
    rec = np.zeros(n, dtype=[(p, "<f4") for p in props])
    for p in props:
        rec[p] = rng.normal(size=n).astype(np.float32)
    path = tmp_path / "inria.ply"
    write_ply(path, [("float", p) for p in props], n, rec.tobytes(),
              header_extra=["comment generated by nothing in particular",
                            "obj_info whatever"])
    scene = load_ply(path, device="cpu")
    want = jload_ply(path)
    assert scene.n == n
    assert np.array_equal(scene.means[:, 0].numpy(), rec["x"])
    assert np.array_equal(scene.quats[:, 0].numpy(), rec["rot_0"])
    for f in SCENE_FIELDS:
        np.testing.assert_array_equal(getattr(scene, f).numpy(),
                                      np.asarray(getattr(want, f)))


def test_load_without_normals(tmp_path):
    """Normals are optional on read (some exporters drop them)."""
    props = [p for p in _FIELDS if p not in ("nx", "ny", "nz")]
    n = 3
    rec = np.zeros(n, dtype=[(p, "<f4") for p in props])
    rec["x"] = [1.0, 2.0, 3.0]
    rec["rot_0"] = 1.0
    path = tmp_path / "nonorm.ply"
    write_ply(path, [("float", p) for p in props], n, rec.tobytes())
    scene = load_ply(path, device="cpu")
    assert scene.n == n
    assert np.array_equal(scene.means[:, 0].numpy(), rec["x"])
    assert torch.equal(scene.quats[:, 0], torch.ones(n))


def test_load_rejections_match_reference(tmp_path):
    """Each refused file raises ValueError with the reference's message:
    no 'ply' magic, an unterminated header, an ASCII body, missing rot_*
    properties, a non-float property, no vertex element."""
    cases = {}
    cases["magic"] = tmp_path / "bad.ply"
    cases["magic"].write_bytes(b"OFF\n3 0 0\nend_header\n")
    cases["unterminated"] = tmp_path / "trunc.ply"
    cases["unterminated"].write_bytes(b"ply\nformat binary_little_endian "
                                      b"1.0\n")
    cases["binary_little_endian"] = tmp_path / "ascii.ply"
    write_ply(cases["binary_little_endian"],
              [("float", p) for p in _FIELDS], 1, b"",
              fmt="format ascii 1.0")
    props = [p for p in _FIELDS if not p.startswith("rot_")]
    cases["rot_0"] = tmp_path / "norot.ply"
    write_ply(cases["rot_0"], [("float", p) for p in props], 1,
              b"\0" * (4 * len(props)))
    cases["non-float"] = tmp_path / "uchar.ply"
    write_ply(cases["non-float"],
              [("float", p) for p in _FIELDS] + [("uchar", "red")], 1,
              b"\0" * (4 * len(_FIELDS) + 1))
    cases["no vertex"] = tmp_path / "noverts.ply"
    cases["no vertex"].write_bytes(b"ply\nformat binary_little_endian 1.0\n"
                                   b"element face 0\nend_header\n")
    for match, path in cases.items():
        with pytest.raises(ValueError, match=match) as got:
            load_ply(path, device="cpu")
        with pytest.raises(ValueError) as want:
            jload_ply(path)
        assert str(got.value) == str(want.value), match


def test_load_ply_places_the_scene_on_the_device(tmp_path):
    """load_ply serves the card by default: its `device` defaults to
    "cuda"; device="cpu" puts every field on the CPU."""
    import inspect
    assert inspect.signature(load_ply).parameters["device"].default == "cuda"
    _, scene = ref_scene(16)
    save_ply(scene, tmp_path / "s.ply")
    back = load_ply(tmp_path / "s.ply", device=torch.device("cpu"))
    assert all(getattr(back, f).device.type == "cpu" for f in SCENE_FIELDS)
