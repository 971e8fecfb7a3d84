"""MS-D2 (a mask plane crossing a collective) over a traced sharded step:
``analysis.dataflow.analyze_sharded_model`` traces the reduced llama2's
forward and ``remat="block"`` gradient under a (model=2) ShardingPolicy on
a fake process group of two ranks (one process, ``make_fx`` fake tensors).
The graphs hold the step's real ``_c10d_functional`` collectives and the
walk is clean; a mutant whose forward all-gathers its shard-local plane
is flagged MS-D2. Plans whose sharded producers differ (qkv with replay,
the carried sites under premask) are walked too.

    PYTHONPATH=src python -m pytest -q tests/test_torch_dataflow_sharded.py
"""
import pytest
import torch

from repro_torch.analysis import dataflow, rules
from repro_torch.config import get_arch
from repro_torch.config.base import DropoutPlanConfig

B, S = 2, 128


def _plan(site, replay):
    return DropoutPlanConfig(mode="overlap", site=site, p=0.1, seed=3,
                             attn_replay=replay)


@pytest.mark.parametrize("site,replay", [("qkv", "auto"), ("qkv", "off"),
                                         ("prev_gemm", "off"),
                                         ("ffn_up", "off")])
def test_sharded_step_trace_is_clean_and_holds_collectives(site, replay):
    cfg = get_arch("llama2-7b", reduced=True)
    graphs = []
    rep = dataflow.analyze_sharded_model(cfg, _plan(site, replay), B, S,
                                         graphs=graphs)
    assert rep.ok, rep.findings
    assert rep.checked_eqns > 0
    fwd, bwd = graphs
    for gm in graphs:
        names = dataflow.collective_nodes(gm)
        assert any(n.startswith("_c10d_functional::") for n in names), names
    # the kernels ran shard-local: each launch is one operator node
    ops = {str(n.target) for n in fwd.graph.nodes
           if n.op == "call_function" and "repro_torch" in str(n.target)}
    assert any("flash_fwd" in o for o in ops), ops
    if site == "qkv":
        assert any("gemm_rng" in o for o in ops), ops


def test_plane_all_gather_mutant_flagged_ms_d2():
    """A forward that all-gathers its shard-local plane (the standalone
    kernel's DTensor made whole) crosses a collective: MS-D2."""
    from repro_torch.core import producer
    cfg = get_arch("llama2-7b", reduced=True)

    def gather_plane(plan, policy, logits):
        plane = producer.standalone_packed_mask(
            plan, B, cfg.n_heads, S, S, 0, 0, policy=policy, device="cpu")
        # the bits leave as a float, so only the crossing is at fault
        return (plane.full_tensor().to(torch.float32).sum() * 0.0,)

    rep = dataflow.analyze_sharded_model(cfg, _plan("qkv", "off"), B, S,
                                         extra=gather_plane,
                                         with_grad=False)
    assert rules.MASK_COLLECTIVE_CROSSING in [f.rule for f in rep.findings]
