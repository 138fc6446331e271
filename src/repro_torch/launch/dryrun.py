"""Multi-pod dry-run: every (arch x shape x mesh) cell counted on the
"meta" device, as the reference's `repro/launch/dryrun.py` compiles them.

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        [--arch NAME] [--shape NAME] [--multi-pod] [--both-meshes] \\
        [--out results.json]

The port has no compiler to ask for `memory_analysis()` or
`cost_analysis()`. A cell instead runs its step once (`launch.steps.
jit_train_step`, `jit_prefill_step` or `jit_decode_step`, the step the
reference lowers) on a `Model` whose parameters, optimizer state,
batch and caches live on the meta device (shapes, no data), placed on
the production mesh of `[torch.device("meta")] * n` positions, under a
dispatch mode (`StepCounter`) that counts:

    flops           each aten op's flops by `torch.utils.flop_counter`'s
                    formulas (its `flop_registry`: matmuls, convolutions,
                    attention; an op it lists no formula for counts 0)
    bytes_accessed  the bytes of each aten op's tensor operands and
                    results; a view (an op whose result aliases an
                    operand) moves nothing and is not counted
    collectives     every collective of `distributed.sharding`
                    (`sharding.counting`), through
                    `roofline.collective_bytes`
    mem             argument_bytes and output_bytes: the bytes of the
                    busiest position's pieces of the step's arguments
                    and results, from their placements at the config's
                    depth (`NamedSharding.local_shape`); temp_bytes: the
                    peak over the step of the live storage that the step
                    made (not its arguments'), summed over the positions
                    and divided by them, a storage that k positions of
                    the repeated mesh share (a collective's result,
                    `CollectiveCounter.shared`) counted k times;
                    peak_bytes = temp + argument, as the reference's

The mesh's positions all run the same program on equal blocks, so a
per-device count is the controller's total over the positions. The
controller also runs a few things once that a real mesh would run on
each device or on one: the loss's mean over the rows and its global
label count, the optimizer's step counter and scalars, and the gather
of whole logits onto the primary device; these are counted once and
divided like the rest, a few bytes of a step.

Depth: a whole-depth run over 256 positions takes minutes of host
Python a layer, so a cell runs each stacked group at two cut depths
(`depths`, default (2, 3)) and extrapolates each count linearly to the
config's depth (`depth_groups`: the dense, SSM or MoE layers,
`first_k_dense`'s dense layers, the hybrid's groups and its tail, the
enc-dec's encoder and decoder). A group no deeper than the first cut
runs whole. One run holds every group at its first cut, and one more
run a group raises that group alone, so the fit is exact for any count
that grows by the same amount each layer, as every count here does
once the peak's place stops moving. `depths=None` runs the cell whole.
`compile_s` keeps the reference's key and holds the runs' wall.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import sys
import time
import traceback
import weakref
from fractions import Fraction

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import ARCHS, SHAPES, get_arch, shape_applicable
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed import sharding as D
from repro_torch.distributed.sharding import Sharded
from repro_torch.launch import roofline as RL
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.model import Model

META = torch.device("meta")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage_key(t: torch.Tensor):
    try:
        return t.untyped_storage()._cdata
    except (RuntimeError, NotImplementedError):   # no storage to hold
        return None


def _flat(x, out: list) -> list:
    """The tensors of an op's arguments or result (tensors, lists and
    tuples of them, dicts of kwargs)."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _flat(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _flat(y, out)
    return out


def tensors_of(tree) -> list:
    """Every tensor of a nested tree of dicts, tuples, lists, `Sharded`
    (its pieces) and `steps.MetaArg` (its value)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, Sharded):
        return list(tree.pieces)
    if isinstance(tree, ST.MetaArg):
        return [tree.value]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in tensors_of(x)]
    return []


class StepCounter(TorchDispatchMode, D.CollectiveCounter):
    """Counts a step's flops, its bytes accessed, the peak of the live
    storage it made
    (`peak`, in bytes summed over positions) and, as the
    `CollectiveCounter` of `sharding.counting`, its collectives.
    `arguments`: tensors whose storage the step was handed; storage that
    an op returns in one of them (an in-place update) is not the step's."""

    def __init__(self, arguments=()):
        TorchDispatchMode.__init__(self)
        D.CollectiveCounter.__init__(self)
        self.flops = 0
        self.bytes_accessed = 0
        self.live = 0
        self.peak = 0
        self._args = {_storage_key(t) for t in arguments}
        self._held: dict = {}           # storage key -> [bytes, k, ref]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _flat(out, [])
        flop = flop_registry.get(func._overloadpacket)
        if flop is not None:
            self.flops += flop(*args, **kwargs, out_val=out)
        if not func.is_view:
            self.bytes_accessed += sum(_nbytes(t) for t in
                                       _flat((args, kwargs), outs[:]))
        for t in outs:
            self._hold(t)
        return out

    def _hold(self, t: torch.Tensor) -> None:
        key = _storage_key(t)
        if key is None or key in self._args or key in self._held:
            return
        st = t.untyped_storage()
        n = st.nbytes()
        self._held[key] = [n, 1, weakref.ref(
            st, lambda _, key=key: self._free(key))]
        self._grow(n)

    def _free(self, key) -> None:
        n, k, _ = self._held.pop(key)
        self.live -= n * k

    def _grow(self, n: int) -> None:
        self.live += n
        self.peak = max(self.peak, self.live)

    def shared(self, tensor: torch.Tensor, k: int) -> None:
        entry = self._held.get(_storage_key(tensor))
        if entry is not None and entry[1] < k:
            self._grow(entry[0] * (k - entry[1]))
            entry[1] = k


@contextlib.contextmanager
def counted(arguments=()):
    """A `StepCounter` over the block, its collectives included."""
    sc = StepCounter(arguments)
    with D.counting(sc), sc:
        yield sc


# --- depth ------------------------------------------------------------------

def depth_groups(cfg: ModelConfig) -> dict:
    """The config's stacked groups and their depths."""
    fam = cfg.family
    if fam == "moe":
        out = dict(layers=cfg.num_layers - cfg.first_k_dense)
        if cfg.first_k_dense:
            out["first"] = cfg.first_k_dense
        return out
    if fam == "hybrid":
        groups, tail = divmod(cfg.num_layers, cfg.attn_every)
        return dict(groups=groups, tail=tail)
    if fam == "encdec":
        return dict(encoder=cfg.encoder_layers, layers=cfg.num_layers)
    return dict(layers=cfg.num_layers)


def at_depth(cfg: ModelConfig, depths: dict) -> ModelConfig:
    """`cfg` with each stacked group at `depths[group]`."""
    fam = cfg.family
    if fam == "moe":
        first = depths.get("first", 0)
        return dataclasses.replace(cfg, first_k_dense=first,
                                   num_layers=first + depths["layers"])
    if fam == "hybrid":
        return dataclasses.replace(cfg, num_layers=depths["groups"]
                                   * cfg.attn_every + depths["tail"])
    if fam == "encdec":
        return dataclasses.replace(cfg, encoder_layers=depths["encoder"],
                                   num_layers=depths["layers"])
    return dataclasses.replace(cfg, num_layers=depths["layers"])


def depth_runs(cfg: ModelConfig, depths) -> list:
    """The depth of each group in each run: all at the first cut, then one
    run a group that is deeper than it, that group at the second cut."""
    full = depth_groups(cfg)
    if depths is None:
        return [full]
    lo, hi = depths
    base = {g: min(n, lo) for g, n in full.items()}
    return [base] + [dict(base, **{g: min(n, hi)})
                     for g, n in full.items() if n > base[g]]


def extrapolate(values: list, runs: list, full: dict):
    """Each group's slope from its run against the first, then the first
    run's value plus every slope times the group's remaining depth: exact
    (a Fraction, an int where the slopes are) for a count linear in each
    group's depth."""
    base, out = Fraction(values[0]), Fraction(values[0])
    for v, r in zip(values[1:], runs[1:]):
        g, = (g for g in r if r[g] != runs[0][g])
        slope = (Fraction(v) - base) / (r[g] - runs[0][g])
        out += slope * (full[g] - runs[0][g])
    return int(out) if out.denominator == 1 else float(out)


# --- one run ------------------------------------------------------------------

def meta_model(cfg: ModelConfig, mesh) -> Model:
    """The model on the meta device, placed on `mesh`."""
    return Model(cfg, device=META, mesh=mesh)


def step_and_args(model: Model, shape: ShapeConfig, mesh) -> tuple:
    """(the bound step, its example arguments (`MetaArg`s), the arguments
    to call it with on the model's own device)."""
    cfg = model.cfg
    if shape.kind == "train":
        opt_cfg = ST.make_opt_cfg(cfg)
        step, example = ST.jit_train_step(model, opt_cfg, mesh, shape)
        opt = ST._opt_module(cfg)
        state = opt.init(model.params(), opt_cfg)
        batch = _on(model.input_specs(shape), model.device)
        return step, example, (state, batch)
    if shape.kind == "prefill":
        step, example = ST.jit_prefill_step(model, mesh, shape)
        return step, example, (_on(model.input_specs(shape),
                                   model.device),)
    step, example = ST.jit_decode_step(model, mesh, shape)
    caches = model.init_caches(shape.global_batch, shape.seq_len)
    tokens = torch.zeros((shape.global_batch, 1), dtype=torch.int64,
                         device=model.device)
    return step, example, (caches, tokens)


def _on(batch: dict, device) -> dict:
    """A meta batch made on `device` (zeros) unless that is meta."""
    if torch.device(device).type == "meta":
        return batch
    return {k: torch.zeros(v.shape, dtype=v.dtype, device=device)
            for k, v in batch.items()}


def count_step(model: Model, step, call_args: tuple) -> dict:
    """One call of `step(*call_args)` under `counted`: flops, bytes, the
    collective records, the live-storage peak (summed over positions) and
    the step's result."""
    arguments = tensors_of(model.params()) + tensors_of(call_args)
    with counted(arguments) as sc:
        out = step(*call_args)
        peak = sc.peak
    return dict(flops=sc.flops, bytes_accessed=sc.bytes_accessed,
                records=list(sc.records), peak=peak, out=out)


# --- placements ---------------------------------------------------------------

def local_bytes(args, position: int = 0) -> int:
    """The bytes of `position`'s pieces of a tree of `MetaArg`s (a 0-d
    leaf is held whole at every position)."""
    total = 0
    for a in _meta_args(args):
        sh = a.sharding
        shape = sh.local_shape(a.value.shape) if a.value.dim() else ()
        total += math.prod(shape) * a.value.element_size()
    return total


def _meta_args(tree) -> list:
    if isinstance(tree, ST.MetaArg):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [a for x in tree for a in _meta_args(x)]
    return []


def placement_bytes(model: Model, shape: ShapeConfig, mesh, example,
                    out) -> tuple:
    """(argument_bytes, output_bytes) of the busiest position, from the
    placements at the model's depth. Train: (params, optimizer state,
    batch) -> (params, optimizer state, metrics); prefill: (params,
    batch) -> (last-token logits whole at the primary position, caches as
    `init_caches` places them); decode: (params, caches, tokens) ->
    (tokens, caches). `out` is a cut run's result (for the metrics' and
    logits' sizes, which depth does not change)."""
    args = local_bytes(example)
    if shape.kind == "train":
        params, opt_state, _ = example
        metrics = sum(_nbytes(v) for v in out[1].values())
        return args, local_bytes(params) + local_bytes(opt_state) + metrics
    b = shape.global_batch
    c_shard = ST.cache_shardings(model, b, shape.seq_len, mesh)
    caches = model.init_caches(b, shape.seq_len, device=META)
    cache_args = D.map_with(lambda x, s: ST.MetaArg(x, s)
                            if torch.is_tensor(x) else x, caches, c_shard)
    if shape.kind == "prefill":
        return args, _nbytes(out[0]) + local_bytes(cache_args)
    return args, local_bytes(example[2]) + local_bytes(cache_args)


# --- a cell -----------------------------------------------------------------

def run_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
             depths=(2, 3), verbose: bool = True) -> dict:
    """The dry-run record of one cell (the reference's schema): the step
    counted on the meta device at the cut `depths` (None: whole) and
    extrapolated to the config's depth (module docstring)."""
    n_dev = mesh.size
    t0 = time.perf_counter()
    full = depth_groups(cfg)
    runs = depth_runs(cfg, depths)
    counts, whole = [], None
    for r in runs:
        model = meta_model(at_depth(cfg, r), mesh)
        step, _, call_args = step_and_args(model, shape, mesh)
        c = count_step(model, step, call_args)
        c["coll"] = RL.collective_bytes(c.pop("records"), n_dev)
        counts.append(c)
        if r == full:
            whole = model
        del model, step, call_args
    kinds = sorted({k for c in counts for k in c["coll"]["per_kind"]})

    def fit(get):
        return extrapolate([get(c) for c in counts], runs, full)
    per_kind = {k: fit(lambda c: c["coll"]["per_kind"].get(k, 0))
                for k in kinds}
    coll = dict(total_bytes=sum(per_kind.values()), per_kind=per_kind,
                num_ops=fit(lambda c: c["coll"]["num_ops"]))
    flops = fit(lambda c: c["flops"])
    nbytes = fit(lambda c: c["bytes_accessed"])
    temp = fit(lambda c: c["peak"]) / n_dev

    model = whole if whole is not None else meta_model(cfg, mesh)
    _, example, _ = step_and_args(model, shape, mesh)
    arg_b, out_b = placement_bytes(model, shape, mesh, example,
                                   counts[0]["out"])
    out = dict(
        arch=cfg.name, shape=shape.name, mesh=str(dict(mesh.shape)),
        devices=n_dev,
        compile_s=round(time.perf_counter() - t0, 1),
        flops=flops / n_dev,
        bytes_accessed=nbytes / n_dev,
        mem=dict(argument_bytes=arg_b, output_bytes=out_b,
                 temp_bytes=temp, peak_bytes=temp + arg_b),
        collectives=coll,
        depths=dict(full=full, runs=runs),
    )
    if verbose:
        peak_gb = out["mem"]["peak_bytes"] / 2**30
        print(f"  OK   meta run={out['compile_s']}s "
              f"flops={out['flops']:.3e} peak={peak_gb:.2f} GiB/dev "
              f"coll={coll['total_bytes']:.3e} B", flush=True)
        print(f"       mem: {out['mem']}", flush=True)
        print(f"       depths: {len(runs)} runs {runs}", flush=True)
    return out


def meta_mesh(multi_pod: bool = False):
    """The production mesh over repeated meta devices."""
    n = 512 if multi_pod else 256
    return make_production_mesh(multi_pod=multi_pod, devices=[META] * n)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    if args.both_meshes:
        meshes = [("single_pod", meta_mesh(False)),
                  ("multi_pod", meta_mesh(True))]
    else:
        name = "multi_pod" if args.multi_pod else "single_pod"
        meshes = [(name, meta_mesh(args.multi_pod))]

    archs = [get_arch(args.arch)] if args.arch else list(ARCHS.values())
    shapes = [SHAPES[args.shape]] if args.shape else list(SHAPES.values())

    results, failures = [], []
    for mesh_name, mesh in meshes:
        for cfg in archs:
            for shape in shapes:
                tag = f"{mesh_name} {cfg.name} x {shape.name}"
                if not shape_applicable(cfg, shape):
                    print(f"SKIP {tag} (long_500k needs sub-quadratic "
                          f"attention; {cfg.family} is full-attention)",
                          flush=True)
                    results.append(dict(arch=cfg.name, shape=shape.name,
                                        mesh=mesh_name, skipped=True))
                    continue
                print(f"CELL {tag}", flush=True)
                try:
                    r = run_cell(cfg, shape, mesh)
                    r["mesh_name"] = mesh_name
                    results.append(r)
                except Exception as e:
                    traceback.print_exc()
                    failures.append(tag)
                    results.append(dict(arch=cfg.name, shape=shape.name,
                                        mesh=mesh_name, error=str(e)[:500]))

    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    print(f"\n{len([r for r in results if 'flops' in r])} counted, "
          f"{len([r for r in results if r.get('skipped')])} skipped, "
          f"{len(failures)} FAILED")
    for f_ in failures:
        print(f"  FAILED: {f_}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
