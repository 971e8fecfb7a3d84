"""``shard_map`` on a torch ``DeviceMesh``, and the collectives its bodies
call.

The JAX package runs every kernel and every explicit collective inside
``jax.shard_map``; the port's counterpart is DTensor's ``local_map``: the
body sees each rank's local tensors, its outputs become DTensors again,
and autograd flows through. Specs are the port's ``P`` (a tuple of mesh
axis names, ``None`` or tuples of names, one entry per tensor dim), turned
into DTensor placements in one place (``placements``): a dim on several
mesh axes, such as ``P(("pod", "data"))``, is ``Shard(dim)`` on each of
those mesh dims, in the mesh's order.

Gradients follow JAX's ``shard_map`` transpose (the unchecked one,
``check_vma=False``): an output's cotangent is divided by the number of
shards of the mesh axes its spec leaves out, and an input's cotangent is
summed over the axes its spec leaves out (a ``Partial`` gradient). The
body's collectives (``psum``, ``pmean``, ``all_gather``, ``psum_scatter``,
``all_to_all``, ``ppermute``) are functional collectives
(``torch.distributed._functional_collectives``), so a ``make_fx`` trace of
a step holds them as ``_c10d_functional`` nodes; each carries JAX's
transpose as its backward. (On a gloo group of CUDA tensors -- two ranks
sharing one card -- ``launch.mesh.stage_gloo_cuda_gathers`` routes the
all-gather through the host.)
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch

__all__ = ["P", "placements", "shard_map", "psum", "pmean", "pmax",
           "all_gather", "psum_scatter", "all_to_all", "ppermute",
           "axis_index", "axis_size", "mesh_axis_names", "mesh_sizes"]

_state = threading.local()


class P:
    """A partition spec: one entry per tensor dim, each a mesh axis name,
    a tuple of names, or None (replicated). Not a tuple, so the port's
    tree walks (``tree.py``) take it as a leaf."""
    __slots__ = ("parts",)

    def __init__(self, *parts):
        self.parts = tuple(tuple(p) if isinstance(p, list) else p
                           for p in parts)

    def __iter__(self):
        return iter(self.parts)

    def __len__(self) -> int:
        return len(self.parts)

    def __getitem__(self, i):
        return self.parts[i]

    def __eq__(self, other) -> bool:
        return isinstance(other, P) and self.parts == other.parts

    def __hash__(self) -> int:
        return hash(self.parts)

    def __repr__(self) -> str:
        return f"P{self.parts!r}"


def mesh_axis_names(mesh) -> Tuple[str, ...]:
    """The mesh's axis names: a ``DeviceMesh``'s ``mesh_dim_names``, or an
    ``AbstractMesh``'s ``axis_names``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        names = mesh.axis_names
    return tuple(names)


def mesh_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or an ``AbstractMesh``."""
    shape = mesh.shape
    if isinstance(shape, dict):
        return dict(shape)
    return dict(zip(mesh_axis_names(mesh), tuple(shape)))


def _axes(part) -> Tuple[str, ...]:
    if part is None:
        return ()
    return (part,) if isinstance(part, str) else tuple(part)


def placements(spec: Sequence, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on every
    mesh dim that tensor dim ``d`` names, ``Replicate()`` elsewhere. A spec
    that names an axis twice, an axis the mesh lacks, or a dim's axes out
    of the mesh's order raises."""
    from torch.distributed.tensor import Replicate, Shard
    names = mesh_axis_names(mesh)
    out = [Replicate() for _ in names]
    seen = set()
    for d, part in enumerate(spec):
        axes = _axes(part)
        order = []
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {tuple(spec)} names axis {a!r}, "
                                 f"which mesh {names} lacks")
            if a in seen:
                raise ValueError(f"spec {tuple(spec)} names axis {a!r} "
                                 "twice")
            seen.add(a)
            order.append(names.index(a))
            out[names.index(a)] = Shard(d)
        if order != sorted(order):
            raise ValueError(f"spec {tuple(spec)} shards dim {d} over "
                             f"{axes}, out of the mesh's order {names}")
    return out


def _unmentioned(spec: Optional[Sequence], mesh) -> Tuple[str, ...]:
    used = {a for part in (spec or ()) for a in _axes(part)}
    return tuple(a for a in mesh_axis_names(mesh) if a not in used)


def _as_dtensor(t: torch.Tensor, mesh):
    """A DTensor as it is; a plain tensor as a DTensor replicated on
    ``mesh`` (a global value every rank holds)."""
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


class _ScaleGrad(torch.autograd.Function):
    """Identity forward; the cotangent times ``scale`` in the backward."""

    @staticmethod
    def forward(ctx, t, scale):
        ctx.scale = scale
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def _scale_out(t, spec, mesh):
    if (not isinstance(t, torch.Tensor) or not t.requires_grad
            or not t.is_floating_point()):
        return t
    sizes = mesh_sizes(mesh)
    n = 1
    for a in _unmentioned(spec, mesh):
        n *= sizes[a]
    return t if n == 1 else _ScaleGrad.apply(t, 1.0 / n)


@contextlib.contextmanager
def _body(mesh):
    prev = getattr(_state, "mesh", None)
    _state.mesh = mesh
    try:
        yield
    finally:
        _state.mesh = prev


def _body_mesh():
    mesh = getattr(_state, "mesh", None)
    if mesh is None:
        raise RuntimeError("a collective over a mesh axis runs only inside "
                           "a shard_map body")
    return mesh


def shard_map(f: Callable, *, mesh, in_specs: Sequence,
              out_specs: Union[Sequence, Tuple]) -> Callable:
    """``f`` run on each rank's local tensors (DTensor's ``local_map``).
    ``in_specs`` has one entry per argument: a ``P`` for a tensor (a plain
    tensor counts as replicated; DTensors are redistributed to the spec),
    ``None`` for anything else (ints pass through). ``out_specs`` is a
    ``P`` for a single tensor output, else a tuple of them. Outputs come
    back as DTensors of those specs."""
    from torch.distributed.tensor import DTensor, Partial
    from torch.distributed.tensor.experimental import local_map

    single = isinstance(out_specs, P)
    outs = (out_specs,) if single else tuple(out_specs)
    out_pl = tuple(placements(sp, mesh) for sp in outs)

    def call(*args):
        if len(args) != len(in_specs):
            raise ValueError(f"{len(args)} arguments for {len(in_specs)} "
                             "in_specs")
        in_pl, grad_pl, dargs = [], [], []
        for a, sp in zip(args, in_specs):
            if sp is None or not isinstance(a, torch.Tensor):
                in_pl.append(None)
                grad_pl.append(None)
                dargs.append(a)
                continue
            pl = placements(sp, mesh)
            unm = set(_unmentioned(sp, mesh))
            gpl = [Partial() if n in unm else p
                   for n, p in zip(mesh_axis_names(mesh), pl)]
            in_pl.append(pl)
            grad_pl.append(gpl)
            dargs.append(_as_dtensor(a, mesh))

        def body(*local):
            with _body(mesh):
                res = f(*local)
            res = (res,) if single else tuple(res)
            res = tuple(_scale_out(r, sp, mesh) for r, sp in zip(res, outs))
            return res[0] if single else res

        if not any(isinstance(a, DTensor) for a in dargs):
            # no tensor operand (a producer fed only seeds): the body
            # makes its outputs from nothing, so wrap them here
            res = body(*dargs)
            res = (res,) if single else tuple(res)
            res = tuple(DTensor.from_local(r, mesh, pl, run_check=False)
                        for r, pl in zip(res, out_pl))
            return res[0] if single else res
        fn = local_map(body, out_placements=out_pl[0] if single else out_pl,
                       in_placements=tuple(in_pl),
                       in_grad_placements=tuple(grad_pl), device_mesh=mesh,
                       redistribute_inputs=True)
        return fn(*dargs)

    return call


# --------------------------------------------------------------------------
# collectives inside a shard_map body
# --------------------------------------------------------------------------

def _dim(mesh, axis: str) -> int:
    return mesh_axis_names(mesh).index(axis)


def axis_size(axes) -> int:
    """The number of shards along ``axes`` (a name or a tuple of names)."""
    sizes = mesh_sizes(_body_mesh())
    n = 1
    for a in _axes(axes):
        n *= sizes[a]
    return n


def axis_index(axes) -> int:
    """This rank's flattened (row-major) index along ``axes``."""
    mesh = _body_mesh()
    sizes = mesh_sizes(mesh)
    idx = 0
    for a in _axes(axes):
        idx = idx * sizes[a] + mesh.get_local_rank(a)
    return idx


def _wait(t):
    from torch.distributed._functional_collectives import \
        AsyncCollectiveTensor
    return t.wait() if isinstance(t, AsyncCollectiveTensor) else t


def _all_reduce(mesh, t, op: str, axes):
    import torch.distributed._functional_collectives as fc
    for a in _axes(axes):
        t = _wait(fc.all_reduce(t.contiguous(), op, (mesh, _dim(mesh, a))))
    return t


def _gather(mesh, t, axis: str, dim: int):
    import torch.distributed._functional_collectives as fc
    return _wait(fc.all_gather_tensor(t.contiguous(), dim,
                                      (mesh, _dim(mesh, axis))))


def _scatter(mesh, t, axis: str, dim: int):
    import torch.distributed._functional_collectives as fc
    return _wait(fc.reduce_scatter_tensor(t.contiguous(), "sum", dim,
                                          (mesh, _dim(mesh, axis))))


def _a2a(mesh, t, axis: str, split_axis: int, concat_axis: int):
    import torch.distributed._functional_collectives as fc
    n = mesh_sizes(mesh)[axis]
    x = t.movedim(split_axis, 0).contiguous()
    got = _wait(fc.all_to_all_single(x, None, None,
                                     (mesh, _dim(mesh, axis))))
    parts = got.reshape((n, got.shape[0] // n) + tuple(got.shape[1:]))
    return torch.cat([p.movedim(0, split_axis) for p in parts],
                     dim=concat_axis)


def _permute(mesh, t, axis: str, perm):
    import torch.distributed._functional_collectives as fc
    n = mesh_sizes(mesh)[axis]
    dst = dict(perm)
    # permute_tensor takes a whole permutation (gloo's all-to-all refuses
    # a shard that sends or gets nothing): pair the shards that send
    # nowhere with those that get nothing, and zero what those get, as
    # JAX does
    idle = [d for d in range(n) if d not in dst.values()]
    src_dst = [dst[s] if s in dst else idle.pop(0) for s in range(n)]
    got = _wait(fc.permute_tensor(t.contiguous().reshape(-1), src_dst,
                                  (mesh, _dim(mesh, axis)))).reshape(t.shape)
    if mesh.get_local_rank(axis) not in dst.values():
        return torch.zeros_like(got)
    return got


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return _all_reduce(mesh, t, "sum", axes)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(ctx.mesh, g, "sum", ctx.axes), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis, dim):
        ctx.args = (mesh, axis, dim)
        return _gather(mesh, t, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _scatter(ctx.args[0], g, *ctx.args[1:]), None, None, None


class _PSumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis, dim):
        ctx.args = (mesh, axis, dim)
        return _scatter(mesh, t, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(ctx.args[0], g, *ctx.args[1:]), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis, split_axis, concat_axis):
        ctx.args = (mesh, axis, split_axis, concat_axis)
        return _a2a(mesh, t, axis, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, split_axis, concat_axis = ctx.args
        return (_a2a(mesh, g, axis, concat_axis, split_axis),
                None, None, None, None)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis, perm):
        ctx.args = (mesh, axis, perm)
        return _permute(mesh, t, axis, perm)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, perm = ctx.args
        inv = [(d, s) for s, d in perm]
        return _permute(mesh, g, axis, inv), None, None, None


def psum(t: torch.Tensor, axes) -> torch.Tensor:
    """Sum over ``axes`` (``jax.lax.psum``); its transpose is a psum."""
    return _PSum.apply(t, _body_mesh(), _axes(axes))


def pmean(t: torch.Tensor, axes) -> torch.Tensor:
    """Mean over ``axes`` (``jax.lax.pmean``)."""
    return psum(t, axes) / axis_size(axes)


def pmax(t: torch.Tensor, axes) -> torch.Tensor:
    """Max over ``axes`` (``jax.lax.pmax``); not differentiable."""
    return _all_reduce(_body_mesh(), t.detach(), "max", _axes(axes))


def all_gather(t: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
    """Concatenate every shard's ``t`` along ``dim`` (``jax.lax.all_gather``
    with ``tiled=True``); its transpose is ``psum_scatter``."""
    return _AllGather.apply(t, _body_mesh(), axis, dim)


def psum_scatter(t: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
    """Sum over ``axis`` and keep this shard's slice of ``dim``
    (``jax.lax.psum_scatter`` with ``tiled=True``)."""
    return _PSumScatter.apply(t, _body_mesh(), axis, dim)


def all_to_all(t: torch.Tensor, axis: str, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """``jax.lax.all_to_all(..., tiled=True)``: split ``split_axis`` into
    one chunk per shard, send chunk j to shard j, and concatenate what
    arrives along ``concat_axis`` in shard order."""
    return _AllToAll.apply(t, _body_mesh(), axis, split_axis, concat_axis)


def ppermute(t: torch.Tensor, axis: str, perm) -> torch.Tensor:
    """``jax.lax.ppermute``: shard ``s`` sends ``t`` to ``d`` for each
    ``(s, d)`` in ``perm``; a shard nobody sends to gets zeros."""
    return _PPermute.apply(t, _body_mesh(), axis,
                           tuple(tuple(p) for p in perm))
