"""PLY import/export for `GaussianScene` (standard 3DGS checkpoint layout).

The interchange format for trained 3DGS scenes is the INRIA reference
implementation's binary PLY: one vertex element per Gaussian with float
properties

    x y z  nx ny nz  f_dc_0 f_dc_1 f_dc_2  [f_rest_*]  opacity
    scale_0 scale_1 scale_2  rot_0 rot_1 rot_2 rot_3

where scales are stored in log space, opacity as the raw sigmoid logit,
rotations as (w, x, y, z) quaternions, and colors as degree-0 spherical
harmonics (f_dc = (rgb - 0.5) / SH_C0). That matches `GaussianScene`
field for field, so the round trip is exact for means, log_scales, quats
and opacity, and exact up to the SH_C0 affine map for colors. Higher-order
SH coefficients (f_rest_*) are not modeled by the blend: `load_ply` skips
them and `save_ply` writes none.

The file is packed and parsed with numpy on the host, in the same float32
arithmetic as the JAX package's `core.io`, so either package reads the
other's files bit for bit and both write the same bytes.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.gaussians import GaussianScene

# Degree-0 real spherical harmonic basis constant: Y_0^0 = 1 / (2*sqrt(pi)).
SH_C0 = 0.28209479177387814

_FIELDS = (
    ["x", "y", "z", "nx", "ny", "nz", "f_dc_0", "f_dc_1", "f_dc_2",
     "opacity", "scale_0", "scale_1", "scale_2",
     "rot_0", "rot_1", "rot_2", "rot_3"])


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().to("cpu", torch.float32).numpy()


def save_ply(scene: GaussianScene, path) -> None:
    """Write `scene` as a standard 3DGS binary-little-endian PLY checkpoint.

    Normals are written as zeros (the layout carries them but no renderer
    reads them); no f_rest_* (degree > 0 SH) properties are emitted, which
    readers treat as a degree-0 checkpoint."""
    n = scene.n
    rec = np.zeros(n, dtype=[(f, "<f4") for f in _FIELDS])
    means, colors = _host(scene.means), _host(scene.colors)
    log_scales, quats = _host(scene.log_scales), _host(scene.quats)
    rec["x"], rec["y"], rec["z"] = means.T
    f_dc = (colors - 0.5) / SH_C0
    rec["f_dc_0"], rec["f_dc_1"], rec["f_dc_2"] = f_dc.T
    rec["opacity"] = _host(scene.opacity_logits)
    rec["scale_0"], rec["scale_1"], rec["scale_2"] = log_scales.T
    for i in range(4):                       # (w, x, y, z) order, rot_0 = w
        rec[f"rot_{i}"] = quats[:, i]
    header = "\n".join(
        ["ply", "format binary_little_endian 1.0",
         f"element vertex {n}"]
        + [f"property float {f}" for f in _FIELDS]
        + ["end_header", ""])
    with open(path, "wb") as fh:
        fh.write(header.encode("ascii"))
        fh.write(rec.tobytes())


def _read_header(fh, path) -> tuple[int, list[str]]:
    """(vertex count, vertex property names) of a binary 3DGS PLY header;
    raises ValueError on anything else."""
    header_lines = []
    while True:
        line = fh.readline()
        if not line:
            raise ValueError(f"{path}: unterminated PLY header")
        line = line.decode("ascii", errors="replace").strip()
        header_lines.append(line)
        if line == "end_header":
            break
    if header_lines[0] != "ply":
        raise ValueError(f"{path}: not a PLY file (missing 'ply' magic)")
    n = None
    props: list[str] = []
    in_vertex = False
    for line in header_lines[1:]:
        parts = line.split()
        if not parts or parts[0] in ("comment", "obj_info"):
            continue
        if parts[0] == "format":
            if parts[1] != "binary_little_endian":
                raise ValueError(
                    f"{path}: unsupported PLY format {parts[1]!r} "
                    "(only binary_little_endian)")
        elif parts[0] == "element":
            in_vertex = parts[1] == "vertex"
            if in_vertex:
                n = int(parts[2])
        elif parts[0] == "property" and in_vertex:
            if parts[1] != "float":
                raise ValueError(
                    f"{path}: non-float vertex property "
                    f"{parts[-1]!r} ({parts[1]})")
            props.append(parts[2])
    if n is None:
        raise ValueError(f"{path}: no vertex element in PLY header")
    required = [f for f in _FIELDS if f not in ("nx", "ny", "nz")]
    missing = [f for f in required if f not in props]
    if missing:
        raise ValueError(
            f"{path}: not a 3DGS checkpoint — missing vertex "
            f"properties {missing}")
    return n, props


def load_ply(path, device="cuda") -> GaussianScene:
    """Read a standard 3DGS binary PLY checkpoint into a `GaussianScene` on
    `device` (the card unless the caller asks for another).

    Tolerant of the variations real checkpoints show: comment/obj_info
    header lines, extra properties (f_rest_* SH coefficients and anything
    else are parsed and ignored), and missing normals. Requires the
    position/f_dc/opacity/scale/rot properties and binary_little_endian
    format; anything else raises ValueError."""
    with open(path, "rb") as fh:
        n, props = _read_header(fh, path)
        rec = np.frombuffer(
            fh.read(n * 4 * len(props)),
            dtype=[(p, "<f4") for p in props], count=n)
    means = np.stack([rec["x"], rec["y"], rec["z"]], 1)
    colors = np.stack([rec["f_dc_0"], rec["f_dc_1"], rec["f_dc_2"]],
                      1) * SH_C0 + 0.5
    log_scales = np.stack([rec[f"scale_{i}"] for i in range(3)], 1)
    quats = np.stack([rec[f"rot_{i}"] for i in range(4)], 1)

    def t(x):
        return torch.from_numpy(np.array(x, np.float32)).to(device)

    return GaussianScene(means=t(means), log_scales=t(log_scales),
                         quats=t(quats), opacity_logits=t(rec["opacity"]),
                         colors=t(colors))
