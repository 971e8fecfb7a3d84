"""Layer 2 of the static mask-safety verifier in the port
(``repro_torch.analysis.dataflow``): the taint walk over the FX graph of
the train step, traced on fake tensors, on the CPU.

Positive half: every shipped reduced config x fixed site (xla, qkv,
prev_gemm, ffn_up, ffn_down) x replay on / off traces clean, forward and
gradient (``remat="block"``); cells whose compiled schedules are equal
trace the same graph and are walked once. This file holds a third of the
configs, ``test_torch_dataflow_archs.py`` and
``test_torch_dataflow_archs2.py`` the rest (so the load spreads over the
suite's workers). Negative half: the leaky mutant and a plane-stacking
mutant give MS-D1, a plane through ``index_select`` / ``gather`` MS-D3, a
hand-built graph with a functional collective on a plane MS-D2, and a
plane as a kernel node's operand MS-D4 under replay while premask
sanctions it (``tests/test_replay.py``'s pair). With every kernel entry
point and plain version patched to raise, a trace still runs: nothing
executes. The lint CLI's Layer-2 exit codes.

    PYTHONPATH=src python -m pytest -q tests/test_torch_dataflow*.py
"""
import pytest
import torch

from repro_torch.analysis import dataflow, lint, rules
from repro_torch.config import get_arch, list_archs
from repro_torch.config.base import DropoutPlanConfig
from repro_torch.core.schedule import compile_schedule
from repro_torch.tree import leaves
from repro_torch.kernels import (
    flash_attention,
    flash_attention_bwd,
    gemm_rng,
    ops,
    philox,
)

SITES = ("xla", "qkv", "prev_gemm", "ffn_up", "ffn_down")
B, S = 1, 128
# the configs in three groups of about equal tracing time
ARCH_GROUPS = (("recurrentgemma-9b", "qwen2-72b", "yi-6b", "rwkv6-7b"),
               ("moonshot-v1-16b-a3b", "qwen3-8b", "llama2-7b",
                "musicgen-large"),
               ("arctic-480b", "chameleon-34b", "command-r-35b",
                "gpt3-175b"))


def _plan(site, replay="auto", dtype="f32"):
    return DropoutPlanConfig(mode="overlap", p=0.1, site=site,
                             gemm_dtype=dtype, attn_replay=replay)


def test_arch_groups_cover_every_shipped_config():
    assert sorted(a for g in ARCH_GROUPS for a in g) == sorted(list_archs())


def sweep_arch(arch):
    """Every fixed site x replay cell of the reduced ``arch``, forward and
    grad traces walked once a distinct schedule; returns the cells
    walked."""
    cfg = get_arch(arch, reduced=True)
    seen = {}
    for site in SITES:
        for replay in ("auto", "off"):
            sched = compile_schedule(cfg, _plan(site, replay), B, S,
                                     attn_impl="pallas")
            key = (sched.carried, sched.assignments)
            if key not in seen:
                seen[key] = dataflow.analyze_model(
                    cfg, _plan(site, replay), B, S, device="cpu",
                    cell=f"{arch} site={site} replay={replay}")
            rep = seen[key]
            assert rep.ok, rep.render()
            assert rep.checked_eqns > 0
    return len(seen)


@pytest.mark.parametrize("arch", ARCH_GROUPS[0])
def test_reduced_cells_trace_clean(arch):
    walked = sweep_arch(arch)
    # only the attention-free config's cells all share one (inert) plan
    assert walked == (1 if arch == "rwkv6-7b" else 10)


# ---------------------------------------------------------------- mutants

def test_leaky_mutant_gives_ms_d1():
    rep = dataflow.analyze_leaky_model(get_arch("yi-6b", reduced=True),
                                       _plan("ffn_up"), B, S, device="cpu")
    assert [f.rule for f in rep.findings] == [rules.MASK_RESIDUAL_LEAK]


def test_plane_stacking_mutant_gives_ms_d1():
    """Per-layer planes stacked (what a scan's ``ys`` would hold), turned
    into a float so no plane reaches an output: the stack alone is the
    leak."""
    cfg = get_arch("llama2-7b", reduced=True)

    def stack(plan, logits):
        planes = [ops.dropout_mask(B, cfg.n_heads, S, S, 0.1,
                                   plan.step_seed(0), plan.salt(layer), 7,
                                   device=logits.device)
                  for layer in range(cfg.n_layers)]
        return (torch.stack(planes).to(torch.float32).sum(),)

    rep = dataflow.analyze_mutant_model(cfg, _plan("qkv"), B, S, stack,
                                        device="cpu")
    assert [f.rule for f in rep.findings] == [rules.MASK_RESIDUAL_LEAK]
    assert "stack" in rep.findings[0].message


def _plane_graph(fn):
    """(graph of ``fn(plane)``, a replay schedule whose planes it
    matches)."""
    cfg = get_arch("llama2-7b", reduced=True)
    sched = compile_schedule(cfg, _plan("ffn_up"), B, S, attn_impl="pallas")
    plane = torch.zeros((B, cfg.n_heads, S // 32, S), dtype=torch.int32)
    return dataflow.trace(fn, plane), cfg, sched


@pytest.mark.parametrize("op", ["index_select", "gather"])
def test_plane_through_index_select_or_gather_gives_ms_d3(op):
    def route(plane):
        idx = torch.arange(plane.shape[0] * plane.shape[1] * plane.shape[2]
                           - 1, -1, -1)
        flat = plane.reshape(-1, plane.shape[-1])
        if op == "index_select":
            out = torch.index_select(flat, 0, idx)
        else:
            out = torch.gather(flat, 0, idx[:, None].expand_as(flat))
        return out.to(torch.float32)

    gm, cfg, sched = _plane_graph(route)
    rep = dataflow.analyze_graph(gm, cfg, sched)
    assert [f.rule for f in rep.findings] == [rules.MASK_TOKEN_GATHER]


def test_functional_collective_on_a_plane_gives_ms_d2():
    """A hand-built graph: a plane into ``_c10d_functional.all_reduce``
    (the port runs one device, so no traced step holds a collective)."""
    cfg = get_arch("llama2-7b", reduced=True)
    sched = compile_schedule(cfg, _plan("qkv"), B, S, attn_impl="pallas")
    with torch._subclasses.fake_tensor.FakeTensorMode():
        val = torch.empty((B, cfg.n_heads, S // 32, S), dtype=torch.int32)
        red = torch.empty((B, cfg.n_heads, S // 32, S), dtype=torch.float32)
    graph = torch.fx.Graph()
    plane = graph.placeholder("plane")
    plane.meta["val"] = val
    coll = graph.call_function(torch.ops._c10d_functional.all_reduce.default,
                               (plane, "sum", "0"))
    coll.meta["val"] = val
    flt = graph.call_function(torch.ops.aten._to_copy.default, (coll,),
                              {"dtype": torch.float32})
    flt.meta["val"] = red
    graph.output((flt,))
    rep = dataflow.analyze_graph(graph, cfg, sched)
    assert [f.rule for f in rep.findings] == [rules.MASK_COLLECTIVE_CROSSING]
    # the same graph without the collective is clean
    clean = torch.fx.Graph()
    p2 = clean.placeholder("plane")
    p2.meta["val"] = val
    f2 = clean.call_function(torch.ops.aten._to_copy.default, (p2,),
                             {"dtype": torch.float32})
    f2.meta["val"] = red
    clean.output((f2,))
    assert dataflow.analyze_graph(clean, cfg, sched).ok


def test_replay_cell_traces_clean_and_plane_operand_gives_ms_d4():
    """A replay cell's real forward and grad traces have no plane operand
    on any kernel node; a premask flash call with a plane does, which
    MS-D4 flags under the replay schedule and the premask schedule
    sanctions (``tests/test_replay.py:294-306``)."""
    cfg = get_arch("llama2-7b", reduced=True)
    rep = dataflow.analyze_model(cfg, _plan("ffn_up"), B, S, device="cpu")
    assert rep.ok, rep.render()
    sched = compile_schedule(cfg, _plan("ffn_up"), B, S, attn_impl="pallas")
    assert sched.replay
    q = torch.zeros((B, cfg.n_heads, S, cfg.head_dim))
    plane = torch.zeros((B, cfg.n_heads, S // 32, S), dtype=torch.int32)
    gm = dataflow.trace(
        lambda q_, m_: flash_attention.flash_attention_fwd(
            q_, q_, q_, m_, causal=True, dropout_p=0.1, mode="premask"),
        q, plane)
    rep = dataflow.analyze_graph(gm, cfg, sched, check_outputs=False)
    assert any(f.rule == rules.MASK_OPERAND_REPLAY for f in rep.findings)
    off = compile_schedule(cfg, _plan("ffn_up", "off"), B, S,
                           attn_impl="pallas")
    assert not off.replay
    assert dataflow.analyze_graph(gm, cfg, off, check_outputs=False).ok


def test_nothing_executes_during_a_trace(monkeypatch):
    """Every kernel entry point and every plain version raises: the
    traces of a premask cell (the Philox bootstrap, the dense and grouped
    hosts, e4m3 included) and of a replay cell run all the same, each
    kernel one opaque node."""
    def boom(*a, **k):
        raise AssertionError("executed during a trace")

    for mod, names in ((philox, ("_kernel_fn", "_plain_words")),
                       (gemm_rng, ("_kernel_fn", "_plain", "_plain_grouped",
                                   "_plain_plane", "gemm_fp8_plain",
                                   "gemm_grouped_fp8_plain")),
                       (flash_attention, ("_kernel_fn", "_fwd_plain")),
                       (flash_attention_bwd, ("_kernel_fn", "_bwd_plain"))):
        for name in names:
            monkeypatch.setattr(mod, name, boom)
    seen = set()
    for arch, site, replay, dtype in (
            ("llama2-7b", "ffn_up", "off", "f32"),
            ("llama2-7b", "qkv", "auto", "fp8"),
            ("moonshot-v1-16b-a3b", "ffn_up", "off", "fp8"),
            ("moonshot-v1-16b-a3b", "ffn_down", "auto", "f32")):
        cfg = get_arch(arch, reduced=True)
        plan = _plan(site, replay, dtype)
        sched = compile_schedule(cfg, plan, B, S, attn_impl="pallas")
        params, x = dataflow.trace_inputs(cfg, B, S, "cpu")
        flat = leaves(params)
        fwd = dataflow._forward_fn(cfg, plan, sched, params, "pallas",
                                   False, torch.float32)
        gm = dataflow.trace(lambda f, t: fwd(f, t, "none"), flat, x)
        seen |= {str(n.target) for n in gm.graph.nodes
                 if str(n.target).startswith("repro_torch.")}
        assert dataflow.analyze_model(cfg, plan, B, S, device="cpu").ok
    assert seen == {"repro_torch.philox_mask.default",
                    "repro_torch.gemm_rng.default",
                    "repro_torch.gemm_rng_fp8.default",
                    "repro_torch.flash_fwd.default"}


# ---------------------------------------------------------------- the CLI

def test_lint_layer2_exit_codes(capsys):
    """``--jaxpr auto`` walks a reduced config's traces a (config, site)
    and exits 0; ``--mutate residual-leak`` exits 1, caught by MS-D1."""
    assert lint.main(["--config", "yi-6b", "--dtype", "f32", "--jaxpr",
                      "auto", "-q"]) == 0
    out = capsys.readouterr().out
    assert "[lint] 12 cells, 0 with findings" in out
    assert lint.main(["--config", "yi-6b", "--mutate",
                      "residual-leak"]) == 1
    out = capsys.readouterr().out
    assert rules.MASK_RESIDUAL_LEAK in out and "caught by" in out
