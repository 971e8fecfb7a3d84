"""Layer 2 of the static mask-safety verifier: a taint walk over an FX
graph of the train step.

``make_fx(..., tracing_mode="fake")`` traces the model's forward, and the
gradient of ``sum(logits) + sum(aux)`` with ``remat="block"`` (the
``torch.utils.checkpoint`` recomputation included), on fake tensors: no
kernel and no plain version runs. Every kernel launch of the port is an
operator of its own (``repro_torch::philox_mask``, ``::gemm_rng``,
``::gemm_rng_fp8``, ``::flash_fwd``, ``::flash_dq``, ``::flash_dkv``),
so each appears as one opaque node, as ``pallas_call`` does in JAX's
jaxpr. The parameters are made under the same fake mode, so a trace of a
full-width model allocates nothing.

Mask-producing nodes are tagged by the port's plane dtype and layouts: a
``torch.int32`` tensor holding uint32 bits (``kernels/philox.py``) of
shape (B, H, SQ/32, SK), (B*H, SQ/32, SK) or (B*H*SQ/32, SK), or a plane
with padded rows: (B, H, R, SK) or (R, SK) of whole (b, h) rows, R >=
SQ/32 (the tensor-op attention pads a plane's rows; JAX's sublane-8 rule
is the TPU's and does not apply). Taint flows through integer and bool
nodes and dies where the bits merge into float compute -- the mask's
one sanctioned exit -- as in the JAX package's walk. A node that writes
one of its operands in place taints it.

Violations:
  MS-D1 mask-residual-leak      a tainted output of the forward trace, or
                                a ``stack`` / ``cat`` with a tainted
                                input. The port's layer loop is Python,
                                so the graph is unrolled and has no scan
                                ``ys``: stacking planes is what per-layer
                                residuals would look like here. Forward
                                trace only, as in JAX.
  MS-D2 mask-collective-crossing a tainted operand of a ``_c10d_functional``
                                / ``c10d`` operator. ``analyze_sharded_model``
                                traces a step under a sharding policy on a
                                fake process group, so the graph holds the
                                step's real collectives (DTensor's
                                redistributions and the shard_map bodies'
                                own).
  MS-D3 mask-token-gather        a tainted data operand (the first) of
                                ``gather``, ``scatter*``, ``index_select``,
                                ``index.Tensor``, ``index_put``, ``sort``
                                or ``take``
  MS-D4 mask-operand-on-replay   a plane as the operand of a kernel node
                                (a ``repro_torch`` operator; the operands
                                it writes are outputs) while the schedule
                                is replay-planned
"""
from __future__ import annotations

import operator
from typing import Callable, Dict, Iterable, List, Optional, Set, Tuple

import torch
from torch.fx.experimental.proxy_tensor import make_fx
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.analysis import rules
from repro_torch.config.base import ModelConfig
from repro_torch.core.overlap import DropoutPlan
from repro_torch.core.schedule import DropoutSchedule

KERNEL_NAMESPACE = "repro_torch"
_COLLECTIVE_NAMESPACES = frozenset({
    "_c10d_functional", "c10d", "c10d_functional",
    "_c10d_functional_autograd"})
# operators that route data by (possibly token-dependent) indices: a
# position-keyed mask entering one means its bits follow token identity
_TOKEN_IDENTITY = frozenset({
    "gather", "scatter", "scatter_add", "scatter_reduce", "index_select",
    "index", "index_put", "_index_put_impl", "sort", "take"})
_STACKING = frozenset({"stack", "cat"})


def mask_shapes(cfg: ModelConfig, sched: DropoutSchedule
                ) -> Set[Tuple[int, ...]]:
    """Every packed-plane shape the schedule's producers emit: global and
    shard-local (B, H, SQ//32, SK) planes plus the kernels' flattened
    (BH, SQ32, SK) / (BH*SQ32, SK) layouts."""
    b, h, sk = sched.batch, cfg.n_heads, sched.seq
    sq32 = sk // 32
    pairs = {(b, h)}
    sh = sched.shard
    if sh.active:
        pairs.add((b // sh.batch_shards, h // sh.head_shards))
    shapes: Set[Tuple[int, ...]] = set()
    for bb, hh in pairs:
        shapes.add((bb, hh, sq32, sk))
        shapes.add((bb * hh, sq32, sk))
        shapes.add((bb * hh * sq32, sk))
    return shapes


def _is_plane(val, shapes: Set[Tuple[int, ...]], sk: int,
              sq32: int) -> bool:
    """True for a tensor the port's producers could have made: int32 of a
    plane's layout, or a plane with padded rows."""
    if not isinstance(val, torch.Tensor) or val.dtype != torch.int32:
        return False
    shape = tuple(val.shape)
    if shape in shapes:
        return True
    if sq32 <= 0 or not shape or shape[-1] != sk:
        return False
    if len(shape) == 2:
        return shape[0] >= sq32 and shape[0] % sq32 == 0
    return (len(shape) == 4 and shape[2] >= sq32
            and (shape[0], shape[1], sq32, sk) in shapes)


def _taintable(val) -> bool:
    """Dtypes taint survives through: ints and bools. Merging into float
    compute is the mask's sanctioned consumption point."""
    if not isinstance(val, torch.Tensor):
        return False
    return not (val.dtype.is_floating_point or val.dtype.is_complex)


def _vals(node) -> List:
    """A node's output values (its ``meta["val"]``) as a list."""
    val = node.meta.get("val")
    if isinstance(val, (tuple, list)):
        return list(val)
    return [val]


def _op_name(target) -> Tuple[str, str]:
    """(namespace, operator name without an in-place underscore) of an
    OpOverload target; ("", "") for anything else."""
    if not isinstance(target, torch._ops.OpOverload):
        return "", ""
    ns, _, name = target._schema.name.partition("::")
    return ns, name.rstrip("_")


def _written_args(target) -> Set[int]:
    """Positions of the operands an operator writes in place."""
    if not isinstance(target, torch._ops.OpOverload):
        return set()
    return {i for i, a in enumerate(target._schema.arguments)
            if a.alias_info is not None and a.alias_info.is_write}


def _tensor_args(args) -> Iterable:
    for a in args:
        if isinstance(a, torch.fx.Node):
            yield a
        elif isinstance(a, (tuple, list)):
            yield from _tensor_args(a)


class _Walker:
    """One pass over an FX graph in topological order (FX graphs have no
    inner graphs here: the layer loop, the checkpoint recomputation and
    autograd are all unrolled by the trace)."""

    def __init__(self, shapes: Set[Tuple[int, ...]], sk: int, sq32: int,
                 check_residuals: bool, replay: bool = False):
        self.shapes = shapes
        self.sk = sk
        self.sq32 = sq32
        self.check_residuals = check_residuals
        self.replay = replay
        self.findings: List[rules.Finding] = []
        self.nodes = 0
        self.taint: Dict[torch.fx.Node, List[bool]] = {}

    def _plane(self, val) -> bool:
        return _is_plane(val, self.shapes, self.sk, self.sq32)

    def _finding(self, rule: str, msg: str) -> None:
        f = rules.Finding(rule, msg)
        if f not in self.findings:
            self.findings.append(f)

    def tainted(self, node) -> bool:
        return any(self.taint.get(node, ()))

    def walk(self, graph: torch.fx.Graph) -> bool:
        """Propagate taint; True when an output of the graph is
        tainted."""
        out_tainted = False
        for node in graph.nodes:
            self.nodes += 1
            if node.op == "output":
                out_tainted = any(self.tainted(a)
                                  for a in _tensor_args(node.args))
                continue
            vals = _vals(node)
            if node.op != "call_function":
                self.taint[node] = [self._plane(v) for v in vals]
                continue
            if node.target is operator.getitem:
                src, idx = node.args
                src_t = self.taint.get(src, [])
                hit = isinstance(idx, int) and idx < len(src_t) and \
                    src_t[idx]
                self.taint[node] = [bool(hit) or self._plane(vals[0])]
                continue
            ins = list(_tensor_args(list(node.args)
                                    + list(node.kwargs.values())))
            in_t = [self.tainted(a) for a in ins]
            self._check(node, ins, in_t)
            any_in = any(in_t)
            self.taint[node] = [(any_in and _taintable(v)) or self._plane(v)
                                for v in vals]
            if any_in:
                # an operand written in place now holds what was merged in
                for i in _written_args(node.target):
                    if i < len(node.args) and isinstance(node.args[i],
                                                         torch.fx.Node):
                        arg = node.args[i]
                        self.taint[arg] = [
                            t or _taintable(v)
                            for t, v in zip(self.taint.get(arg, [False]),
                                            _vals(arg))]
        return out_tainted

    def _check(self, node, ins, in_t: List[bool]) -> None:
        ns, name = _op_name(node.target)
        if ns in _COLLECTIVE_NAMESPACES and any(in_t):
            self._finding(
                rules.MASK_COLLECTIVE_CROSSING,
                f"packed mask bits cross collective `{ns}::{name}` -- "
                "shard-local counter windows must never leave their "
                "shard")
        if ns == "aten" and name in _TOKEN_IDENTITY and node.args and \
                isinstance(node.args[0], torch.fx.Node) and \
                self.tainted(node.args[0]):
            self._finding(
                rules.MASK_TOKEN_GATHER,
                f"packed mask bits are the data operand of `{name}` -- "
                "position-keyed bits routed by token identity "
                "(MoE-dispatch permutation invariant)")
        if self.check_residuals and ns == "aten" and name in _STACKING \
                and any(in_t):
            self._finding(
                rules.MASK_RESIDUAL_LEAK,
                f"packed mask bits are stacked by `{name}` -- masks "
                "materialized per layer outside the carried plane")
        if self.replay and ns == KERNEL_NAMESPACE:
            # zero-HBM contract: replay kernels take the seed-salt words,
            # never a packed plane
            written = _written_args(node.target)
            for i, a in enumerate(node.args):
                if i in written or not isinstance(a, torch.fx.Node):
                    continue
                val = a.meta.get("val")
                if self._plane(val):
                    self._finding(
                        rules.MASK_OPERAND_REPLAY,
                        f"packed mask plane {tuple(val.shape)} is an "
                        f"operand of kernel `{name}` on a replay-planned "
                        "schedule -- zero-HBM replay degraded to premask "
                        "traffic")


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------

def trace(fn: Callable, *args) -> torch.fx.GraphModule:
    """``fn`` traced on fake tensors (the inputs' fake mode if they have
    one): every kernel launch one opaque node, nothing executed."""
    return make_fx(fn, tracing_mode="fake",
                   _allow_non_fake_inputs=True)(*args)


def analyze_graph(gm, cfg: ModelConfig, sched: DropoutSchedule, *,
                  check_residuals: bool = True, check_outputs: bool = True,
                  cell: str = "") -> rules.Report:
    """Walk one traced graph (a GraphModule or a Graph) for mask-scope
    violations."""
    graph = gm.graph if isinstance(gm, torch.fx.GraphModule) else gm
    walker = _Walker(mask_shapes(cfg, sched), sched.seq, sched.seq // 32,
                     check_residuals, replay=sched.replay)
    if walker.walk(graph) and check_outputs:
        walker.findings.append(rules.Finding(
            rules.MASK_RESIDUAL_LEAK,
            "packed mask bits reach an output of the traced function -- "
            "masks must stay internal to the step"))
    return rules.Report(cell=cell or "graph",
                        findings=tuple(walker.findings),
                        checked_eqns=walker.nodes)


def trace_inputs(cfg: ModelConfig, batch: int, seq: int, device=None):
    """Fake (params, inputs) of one cell, made under one fake mode: a
    full-width model's trace allocates nothing."""
    from repro_torch.device import resolve_device
    from repro_torch.models import model_init
    dev = resolve_device(device)
    with FakeTensorMode(allow_non_fake_inputs=True):
        params = model_init(cfg, seed=0, device=dev)
        if cfg.frontend == "token":
            inputs = torch.zeros((batch, seq), dtype=torch.int32,
                                 device=dev)
        else:
            inputs = torch.zeros((batch, seq, cfg.d_model),
                                 dtype=torch.float32, device=dev)
    return params, inputs


def _forward_fn(cfg: ModelConfig, plan_cfg, sched: DropoutSchedule,
                params, attn_impl: str, moe_seq_dispatch: bool,
                compute_dtype, extra: Optional[Callable] = None):
    """fn(flat params, inputs, remat) -> the forward's outputs, plus what
    ``extra(plan, outputs)`` adds (a mutant)."""
    from repro_torch.models import Runtime, forward
    from repro_torch.tree import unflatten_like
    plan = DropoutPlan(plan_cfg)

    def fwd(flat, inputs, remat):
        p = unflatten_like(params, [t.to(compute_dtype) for t in flat])
        rt = Runtime(plan=plan, step=0, compute_dtype=compute_dtype,
                     remat=remat, attn_impl=attn_impl, schedule=sched)
        logits, aux = forward(p, cfg, rt, inputs)
        if extra is not None:
            return (logits, aux) + tuple(extra(plan, logits))
        return logits, aux
    return fwd


def analyze_model(cfg: ModelConfig, plan_cfg, batch: int, seq: int, *,
                  attn_impl: str = "pallas", with_grad: bool = True,
                  moe_seq_dispatch: bool = False, cell: str = "",
                  device=None, compute_dtype=torch.float32,
                  timings: Optional[Dict[str, float]] = None
                  ) -> rules.Report:
    """Trace the model's forward, and the gradient of ``sum(logits) +
    sum(aux)`` under ``remat="block"``, for one cell on fake tensors and
    walk both graphs. Nothing executes. ``timings`` (a dict) gets each
    trace's and walk's seconds and node counts."""
    import time

    from repro_torch.core.schedule import compile_schedule
    from repro_torch.tree import leaves
    sched = compile_schedule(cfg, plan_cfg, batch, seq, attn_impl=attn_impl,
                             moe_seq_dispatch=moe_seq_dispatch)
    params, inputs = trace_inputs(cfg, batch, seq, device)
    flat = leaves(params)
    cell = cell or (f"{cfg.name} site={plan_cfg.site} "
                    f"dtype={plan_cfg.gemm_dtype}")
    fwd = _forward_fn(cfg, plan_cfg, sched, params, attn_impl,
                      moe_seq_dispatch, compute_dtype)
    t0 = time.perf_counter()
    gm = trace(lambda f, x: fwd(f, x, "none"), flat, inputs)
    t1 = time.perf_counter()
    rep = analyze_graph(gm, cfg, sched, cell=cell + " [fwd]")
    t2 = time.perf_counter()
    findings = list(rep.findings)
    nodes = rep.checked_eqns
    if timings is not None:
        timings.update(fwd_nodes=rep.checked_eqns, fwd_trace_s=t1 - t0,
                       fwd_walk_s=t2 - t1)
    if with_grad:
        def grad(f, x):
            f = [t.detach().requires_grad_() for t in f]
            logits, aux = fwd(f, x, "block")
            return torch.autograd.grad(logits.sum() + aux.sum(), f,
                                       allow_unused=True)

        gm_g = trace(grad, flat, inputs)
        t3 = time.perf_counter()
        # residual / stacking checks are forward-only (module doc)
        rep_g = analyze_graph(gm_g, cfg, sched, check_residuals=False,
                              check_outputs=False, cell=cell + " [bwd]")
        t4 = time.perf_counter()
        findings.extend(rep_g.findings)
        nodes += rep_g.checked_eqns
        if timings is not None:
            timings.update(grad_nodes=rep_g.checked_eqns,
                           grad_trace_s=t3 - t2, grad_walk_s=t4 - t3)
    return rules.Report(cell=cell, findings=tuple(findings),
                        checked_eqns=nodes)


def analyze_mutant_model(cfg: ModelConfig, plan_cfg, batch: int, seq: int,
                         extra: Callable, *, attn_impl: str = "pallas",
                         device=None, cell: str = "") -> rules.Report:
    """Trace a forward that also returns ``extra(plan, logits)`` (a tuple
    of tensors) and walk it: the negative controls' harness."""
    from repro_torch.core.schedule import compile_schedule
    from repro_torch.tree import leaves
    sched = compile_schedule(cfg, plan_cfg, batch, seq, attn_impl=attn_impl)
    params, inputs = trace_inputs(cfg, batch, seq, device)
    fwd = _forward_fn(cfg, plan_cfg, sched, params, attn_impl, False,
                      torch.float32, extra)
    gm = trace(lambda f, x: fwd(f, x, "none"), leaves(params), inputs)
    return analyze_graph(gm, cfg, sched, cell=cell or f"{cfg.name} [mutant]")


def analyze_leaky_model(cfg: ModelConfig, plan_cfg, batch: int, seq: int,
                        *, attn_impl: str = "pallas", device=None
                        ) -> rules.Report:
    """Negative control for MS-D1 (``lint --mutate residual-leak``): trace
    a forward that also returns its packed mask plane, made by the
    standalone Philox kernel -- the analyzer must flag the escape."""
    from repro_torch.core import producer

    def leak(plan, logits):
        return (producer.standalone_packed_mask(
            plan, batch, cfg.n_heads, seq, seq, 0, 0,
            device=logits.device),)
    return analyze_mutant_model(cfg, plan_cfg, batch, seq, leak,
                                attn_impl=attn_impl, device=device,
                                cell=f"{cfg.name} [leak-mutant]")


def _fake_group(world: int):
    """A fake process group of ``world`` ranks in this process (rank 0),
    started when none runs; returns whether this call started it."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise RuntimeError(f"a process group of {dist.get_world_size()} "
                               f"ranks runs; the trace needs {world}")
        return False
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    return True


def analyze_sharded_model(cfg: ModelConfig, plan_cfg, batch: int, seq: int,
                          *, mesh_shape=(2,), axes=("model",),
                          with_grad: bool = True,
                          extra: Optional[Callable] = None,
                          graphs: Optional[list] = None) -> rules.Report:
    """Trace one step of ``cfg`` (the flash path, ``attn_impl="pallas"``)
    under a ShardingPolicy on a ``mesh_shape`` mesh of a fake process
    group (one process, rank 0's view) and walk
    its forward and, with ``with_grad``, its ``remat="block"`` gradient.
    The traced function takes rank 0's parameter shards and batch rows as
    plain fake tensors and wraps them as DTensors, so the graph holds the
    local ops and every collective the sharded step runs. ``extra(plan,
    policy, logits)`` adds outputs (a mutant); ``graphs`` (a list) gets the
    traced GraphModules."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    from repro_torch.compat import placements
    from repro_torch.core.schedule import compile_schedule
    from repro_torch.distributed.sharding import ShardingPolicy, distribute
    from repro_torch.distributed.specs import param_specs
    from repro_torch.models import Runtime, forward
    from repro_torch.tree import leaves, unflatten_like
    world = 1
    for n in mesh_shape:
        world *= n
    started = _fake_group(world)
    try:
        mesh = init_device_mesh("cpu", tuple(mesh_shape),
                                mesh_dim_names=tuple(axes))
        policy = ShardingPolicy(mesh)
        sched = compile_schedule(cfg, plan_cfg, batch, seq, policy=policy,
                                 attn_impl="pallas")
        params, inputs = trace_inputs(cfg, batch, seq, "cpu")
        specs = leaves(param_specs(params, policy))
        pls = [placements(sp, mesh) for sp in specs]
        x_spec = policy.spec(("batch",) + (None,) * (inputs.ndim - 1),
                             tuple(inputs.shape))
        x_pl = placements(x_spec, mesh)
        local = [distribute(t, sp, mesh).to_local()
                 for t, sp in zip(leaves(params), specs)]
        x_local = distribute(inputs, x_spec, mesh).to_local()
        plan = DropoutPlan(plan_cfg)
        cell = (f"{cfg.name} site={plan_cfg.site} mesh="
                f"{dict(zip(axes, mesh_shape))}")

        def fwd(flat, x, remat):
            p = unflatten_like(params, [
                DTensor.from_local(t, mesh, pl, run_check=False)
                for t, pl in zip(flat, pls)])
            xd = DTensor.from_local(x, mesh, x_pl, run_check=False)
            rt = Runtime(plan=plan, step=0, remat=remat,
                         attn_impl="pallas", schedule=sched, policy=policy)
            logits, aux = forward(p, cfg, rt, xd)
            out = (logits.to_local(), aux.to_local())
            if extra is not None:
                out += tuple(extra(plan, policy, logits))
            return out

        gm = trace(lambda f, x: fwd(f, x, "none"), local, x_local)
        if graphs is not None:
            graphs.append(gm)
        rep = analyze_graph(gm, cfg, sched, cell=cell + " [fwd]")
        findings, nodes = list(rep.findings), rep.checked_eqns
        if with_grad:
            def grad(f, x):
                f = [t.detach().requires_grad_() for t in f]
                logits, aux = fwd(f, x, "block")[:2]
                return torch.autograd.grad(logits.sum() + aux.sum(), f,
                                           allow_unused=True)

            gm_g = trace(grad, local, x_local)
            if graphs is not None:
                graphs.append(gm_g)
            rep_g = analyze_graph(gm_g, cfg, sched, check_residuals=False,
                                  check_outputs=False, cell=cell + " [bwd]")
            findings.extend(rep_g.findings)
            nodes += rep_g.checked_eqns
        return rules.Report(cell=cell, findings=tuple(findings),
                            checked_eqns=nodes)
    finally:
        if started:
            dist.destroy_process_group()


def collective_nodes(gm) -> List[str]:
    """The collective operators of a traced graph, by name."""
    graph = gm.graph if isinstance(gm, torch.fx.GraphModule) else gm
    out = []
    for node in graph.nodes:
        if node.op == "call_function":
            ns, name = _op_name(node.target)
            if ns in _COLLECTIVE_NAMESPACES:
                out.append(f"{ns}::{name}")
    return out
