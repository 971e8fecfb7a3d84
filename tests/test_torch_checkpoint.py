"""Checkpoints, the dropout contract, crash recovery and the training
launcher of the port (``repro_torch.checkpoint``, ``distributed``,
``data.pipeline``, ``launch.train``, the serve engine's admission
contract) against the JAX package's, on the CPU at reduced sizes.

- The contract's JSON and ``schedule_sha256`` are JAX's byte for byte for
  the same plan and shape, and a JAX-frozen contract verifies against the
  port's schedule; identity drift raises naming the field; realization
  drift needs the proof and then "recompiled", a topology-2 recompile
  through the counter layer.
- The Checkpointer cases of JAX's ``test_fault_recovery.py`` and
  ``test_chaos.py``: meta-file preference, dtype-drift refusal, a killed
  write never published, the restart budget, the failed-save fallback.
- ``TrainRunner`` recovery equals the uninterrupted run bitwise, and the
  chaos kill phases (mid-forward, mid-backward, a killed write, a
  straggler) recover to the same loss bits and mask digests (the digests
  are JAX's recorder's too).
- The heartbeat's beat is written to a temporary file and renamed, so a
  reader never sees it empty (the JAX package's truncates first).
- The launcher runs and resumes on ``--device cpu`` ("verified"), a
  changed site resumes "recompiled", a changed p raises.
- The engine's ``verify_request_contract``; ``device_batch`` and
  ``Prefetcher``.

    PYTHONPATH=src python -m pytest -q tests/test_torch_checkpoint.py
"""
import dataclasses
import json
import os
import time

import numpy as np
import pytest
import torch

from repro.checkpoint import DropoutContract as JDropoutContract
from repro.checkpoint import contract_from_schedule as j_contract
from repro.checkpoint import schedule_digest as j_digest
from repro.config import get_arch as j_get_arch
from repro.config.base import DropoutPlanConfig as JPlanConfig
from repro.core.overlap import plan_from_config as j_plan_from_config
from repro.core.schedule import compile_schedule as j_compile
from repro.distributed.chaos import TrajectoryRecorder as JRecorder
from repro_torch import tree
from repro_torch.analysis import MaskSafetyError
from repro_torch.analysis.lint import topology_shards
from repro_torch.checkpoint import (
    Checkpointer,
    CheckpointWriteError,
    ContractMismatchError,
    DropoutContract,
    contract_from_schedule,
    schedule_digest,
    verify_resume,
)
from repro_torch.config import (
    DropoutPlanConfig,
    OptimizerConfig,
    RunConfig,
    ShapeConfig,
    ShardingConfig,
    StepKind,
    TrainConfig,
    get_arch,
)
from repro_torch.core.overlap import DropoutPlan
from repro_torch.core.schedule import compile_schedule
from repro_torch.data import Prefetcher, batch_for_step, device_batch
from repro_torch.distributed.chaos import (
    ChaosCheckpointer,
    ChaosMonkey,
    Fault,
    TrajectoryRecorder,
)
from repro_torch.distributed.fault import (
    Heartbeat,
    StragglerDetector,
    TrainRunner,
)
from repro_torch.launch import train as launcher
from repro_torch.serve import ServeConfig, ServeEngine
from repro_torch.train import init_train_state, make_train_step

SITES = ("xla", "qkv", "prev_gemm", "ffn_up", "ffn_down")
CONTRACT_ARCHS = ("llama2-7b", "yi-6b", "moonshot-v1-16b-a3b",
                  "recurrentgemma-9b")


# ------------------------------------------------------------ the contract

@pytest.mark.parametrize("arch", CONTRACT_ARCHS)
def test_contract_json_equals_jax(arch):
    """Reduced configs at B = 2, S = 32 and 128, every fixed site under
    both impls: the port's contract JSON and schedule digest are JAX's
    byte for byte, and a JAX-frozen contract gives "verified" against the
    port's."""
    cfg, jcfg = get_arch(arch, reduced=True), j_get_arch(arch, reduced=True)
    for seq in (32, 128):
        for site in SITES:
            for impl in ("pallas", "xla"):
                kw = dict(mode="overlap", p=0.1, seed=3, site=site)
                sched = compile_schedule(cfg, DropoutPlanConfig(**kw), 2,
                                         seq, attn_impl=impl)
                jsched = j_compile(jcfg, JPlanConfig(**kw), 2, seq,
                                   attn_impl=impl)
                assert schedule_digest(sched) == j_digest(jsched)
                got = contract_from_schedule(cfg, sched)
                want = j_contract(jcfg, jsched)
                assert got.to_json() == want.to_json()
                frozen = DropoutContract.from_json(want.to_json())
                assert verify_resume(frozen, got) == "verified"
                assert JDropoutContract.from_json(got.to_json()) == want


def _contract(seed=0, site="qkv", p=0.1, rounds=7):
    cfg = get_arch("llama2-7b", reduced=True)
    plan = DropoutPlanConfig(mode="overlap", p=p, seed=seed, site=site,
                             philox_rounds=rounds)
    sched = compile_schedule(cfg, plan, 2, 128, attn_impl="pallas")
    return cfg, sched, contract_from_schedule(cfg, sched)


def test_contract_roundtrip_verified():
    _, _, c = _contract()
    c2 = DropoutContract.from_json(c.to_json())
    assert c2 == c
    assert verify_resume(c2, c) == "verified"


@pytest.mark.parametrize("field,kw", [("seed", dict(seed=1)),
                                      ("p", dict(p=0.2)),
                                      ("philox_rounds", dict(rounds=10))])
def test_contract_identity_drift_raises_naming_the_field(field, kw):
    _, _, saved = _contract()
    _, _, cur = _contract(**kw)
    with pytest.raises(ContractMismatchError) as ei:
        verify_resume(saved, cur)
    msg = str(ei.value)
    assert f"{field}:" in msg and "different mask bits" in msg.lower()


def test_contract_realization_drift_needs_proof():
    """A changed site makes the same bits with other producers: without
    the new schedule the restore refuses; with it the counter layer proves
    it and the verdict is "recompiled"."""
    _, _, saved = _contract(site="qkv")
    cfg, sched, cur = _contract(site="ffn_up")
    with pytest.raises(ContractMismatchError, match="realization"):
        verify_resume(saved, cur)
    assert verify_resume(saved, cur, cfg=cfg, sched=sched) == "recompiled"


def test_contract_reshard_recompile_lints_per_topology():
    """A contract saved unsharded against 2-way data- and model-axis
    schedules: the same identity, a drifted realization, each new schedule
    proven by the counter layer ("recompiled")."""
    cfg = get_arch("llama2-7b")
    plan = DropoutPlanConfig(mode="overlap", p=0.1, site="qkv")
    saved = contract_from_schedule(cfg, compile_schedule(
        cfg, plan, 8, 1024, attn_impl="pallas"))
    for shard in topology_shards(2):
        sched = compile_schedule(cfg, plan, 8, 1024, attn_impl="pallas",
                                 shard=shard)
        cur = contract_from_schedule(cfg, sched)
        assert cur.realization["shards"] != saved.realization["shards"]
        assert verify_resume(saved, cur, cfg=cfg, sched=sched) == \
            "recompiled"


def test_contract_recompile_refuses_an_unsafe_schedule():
    """A realization drift whose schedule the counter layer refutes (a
    corrupted stride) raises MaskSafetyError, not "recompiled"."""
    from repro_torch.analysis.counters import corrupt_schedule_stride
    _, _, saved = _contract(site="qkv")
    cfg, sched, cur = _contract(site="ffn_up")
    with pytest.raises(MaskSafetyError):
        verify_resume(saved, cur, cfg=cfg,
                      sched=corrupt_schedule_stride(sched))


# ---------------------------------------------------------- checkpointer

def _toy():
    """A pure-arithmetic step: state {"step", "w"}, w a function of (w,
    step), loss = sum(w)."""
    def step_fn(state, x, y):
        w = state["w"] * 1.0001 + x
        return {"step": state["step"] + 1, "w": w}, {"loss": w.sum()}

    def batch_fn(step):
        return torch.tensor(step * 0.01, dtype=torch.float32), None

    return step_fn, batch_fn, {"step": 0,
                               "w": torch.arange(4, dtype=torch.float32)}


def _toy_run(n):
    step_fn, batch_fn, state = _toy()
    for s in range(n):
        state, _ = step_fn(state, *batch_fn(s))
    return state


def test_latest_step_prefers_meta_with_fallback(tmp_path):
    ckpt = Checkpointer(str(tmp_path), async_save=False)
    assert ckpt.latest_step() is None
    state = {"step": 0, "w": torch.ones(2)}
    ckpt.save(2, state)
    ckpt.save(4, state)
    meta = tmp_path / "latest"
    assert json.loads(meta.read_text())["step"] == 4
    assert ckpt.latest_step() == 4
    meta.write_text(json.dumps({"step": 2}))
    assert ckpt.latest_step() == 2
    meta.write_text(json.dumps({"step": 99}))
    assert ckpt.latest_step() == 4
    meta.write_text("{not json")
    assert ckpt.latest_step() == 4
    meta.write_text(json.dumps({"wrong_key": 1}))
    assert ckpt.latest_step() == 4


def test_keep_collects_old_checkpoints(tmp_path):
    ckpt = Checkpointer(str(tmp_path), keep=2, async_save=True)
    for s in (1, 2, 3, 4):
        ckpt.save(s, {"step": s, "w": torch.full((3,), float(s))})
    ckpt.wait()
    assert ckpt.all_steps() == [3, 4]


def test_restore_round_trips_and_refuses_dtype_drift(tmp_path):
    """Keys are JAX's tree paths; the restore is bitwise, an int leaf
    comes back an int, and a template of another dtype is refused."""
    ckpt = Checkpointer(str(tmp_path), async_save=False)
    w = torch.randn(2, 2, generator=torch.Generator().manual_seed(0))
    state = {"step": 4, "w": w, "opt": {"m": [w * 2, w * 3]}}
    ckpt.save(4, state)
    with np.load(tmp_path / "ckpt_4.npz") as z:
        assert sorted(z.files) == ["['opt']['m'][0]", "['opt']['m'][1]",
                                   "['step']", "['w']"]
    good = ckpt.restore(4, {"step": 0, "w": torch.zeros(2, 2),
                            "opt": {"m": [torch.zeros(2, 2)] * 2}})
    assert good["step"] == 4 and isinstance(good["step"], int)
    assert torch.equal(good["w"], w)
    assert torch.equal(good["opt"]["m"][1], w * 3)
    bad = {"step": 0, "w": torch.zeros(2, 2, dtype=torch.float64),
           "opt": {"m": [torch.zeros(2, 2)] * 2}}
    with pytest.raises(ValueError, match=r"dtype drift.*\['w'\]"):
        ckpt.restore(4, bad)


def test_checkpoint_is_an_npz_and_its_crc_is_checked(tmp_path):
    """The file is an uncompressed .npz that ``np.load`` reads as written;
    a payload byte flipped on disk fails the restore's CRC check."""
    ckpt = Checkpointer(str(tmp_path), async_save=True)
    w = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    ckpt.save(2, {"step": 2, "w": w})
    ckpt.wait()
    path = tmp_path / "ckpt_2.npz"
    with np.load(path) as z:
        assert np.array_equal(z["['w']"], w.numpy())
        assert int(z["['step']"]) == 2
    raw = bytearray(path.read_bytes())
    at = raw.index(w.numpy().tobytes())
    raw[at + 5] ^= 0x40
    path.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="CRC"):
        ckpt.restore(2, {"step": 0, "w": torch.zeros(3, 4)})


def test_killed_write_never_publishes_partial(tmp_path):
    ckpt = ChaosCheckpointer(str(tmp_path), kill_steps={8},
                             async_save=False)
    state = {"step": 4, "w": torch.ones(3)}
    ckpt.save(4, state)
    ckpt.save(8, {**state, "step": 8})
    with pytest.raises(CheckpointWriteError, match="never published"):
        ckpt.wait()
    assert ckpt.latest_step() == 4
    assert os.path.exists(tmp_path / "tmp.8")
    assert not os.path.exists(tmp_path / "ckpt_8.npz")


def test_max_restarts_reraises_original_error(tmp_path):
    _, batch_fn, state = _toy()

    def always_crash(st, x, y):
        raise RuntimeError("persistent node failure")

    runner = TrainRunner(always_crash, state, batch_fn,
                         Checkpointer(str(tmp_path), async_save=False),
                         checkpoint_every=4, max_restarts=2)
    with pytest.raises(RuntimeError, match="persistent node failure"):
        runner.run(8)
    assert runner.restarts == 3


def test_failed_async_save_falls_back(tmp_path):
    """A killed write is charged to failed_saves, not the restart budget;
    recovery restores the last checkpoint that landed and still reproduces
    the uninterrupted run."""
    step_fn, batch_fn, state = _toy()
    crashes = {5}

    def hook(step):
        if step in crashes:
            crashes.discard(step)
            raise RuntimeError(f"injected node failure at {step}")

    ckpt = ChaosCheckpointer(str(tmp_path), kill_steps={4}, async_save=True)
    runner = TrainRunner(step_fn, state, batch_fn, ckpt, checkpoint_every=2,
                         max_restarts=3, failure_hook=hook)
    report = runner.run(8)
    assert ckpt.killed_writes == [4]
    assert (report.failed_saves, report.restarts,
            report.steps_completed) == (1, 1, 8)
    assert torch.equal(runner.state["w"], _toy_run(8)["w"])


def test_runner_contract_mismatch_fails_fast(tmp_path):
    cfg, sched, saved = _contract(seed=0)
    _, _, current = _contract(seed=1)
    ckpt = Checkpointer(str(tmp_path), async_save=False)
    state = {"step": 4, "w": torch.ones(3)}
    ckpt.save(4, state, contract=saved)

    def step_fn(st, x, y):
        if int(st["step"]) == 5:
            raise RuntimeError("injected crash")
        return {**st, "step": st["step"] + 1}, {"loss": torch.zeros(())}

    runner = TrainRunner(step_fn, dict(state), lambda s: (None, None), ckpt,
                         checkpoint_every=100, max_restarts=3,
                         contract=current, model_cfg=cfg, schedule=sched)
    with pytest.raises(ContractMismatchError, match="seed"):
        runner.run(8)
    assert runner.restarts == 1


# ----------------------------------------------- stragglers, heartbeats

def test_straggler_detector():
    det = StragglerDetector(window=8, k=2.0, warmup=5)
    for d in (0.01, 0.01, 50.0, 0.01, 0.01):
        assert det.observe(d) is False
    det = StragglerDetector(window=16, k=4.0, warmup=4)
    for _ in range(8):
        det.observe(0.10)
    for _ in range(6):
        assert det.observe(1.0) is True
    assert len(det.flagged) == 6 and max(det.times) == pytest.approx(0.10)
    assert det.straggler_fraction == pytest.approx(6 / 14)
    assert det.observe(0.10) is False


def test_heartbeat_never_reads_empty(tmp_path):
    """The beat is written aside and renamed into place: a reader polling
    as fast as it can, beside a beat every 0.5 ms, always reads a whole
    timestamp once the first beat landed; staleness and corruption still
    read dead."""
    path = str(tmp_path / "hb")
    assert Heartbeat.is_alive(path, timeout_s=10.0) is False
    hb = Heartbeat(path, interval_s=0.0005)
    hb.start()
    try:
        deadline = time.time() + 2.0
        while not os.path.exists(path) and time.time() < deadline:
            time.sleep(0.001)
        bad = 0
        for _ in range(3000):
            with open(path) as f:
                text = f.read()
            try:
                float(text)
            except ValueError:
                bad += 1
        assert bad == 0
        assert Heartbeat.is_alive(path, timeout_s=5.0) is True
    finally:
        hb.stop()
    with open(path, "w") as f:
        f.write(str(time.time() - 60.0))
    assert Heartbeat.is_alive(path, timeout_s=1.0) is False
    with open(path, "w") as f:
        f.write("not-a-timestamp")
    assert Heartbeat.is_alive(path, timeout_s=1e9) is False


# ------------------------------------------------- recovery, bitwise

def _setup(remat="block"):
    cfg = get_arch("llama2-7b", reduced=True)
    shape = ShapeConfig("chaos", seq_len=32, global_batch=2,
                        kind=StepKind.TRAIN)
    run = RunConfig(model=cfg, shape=shape,
                    dropout=DropoutPlanConfig(mode="overlap", p=0.1),
                    sharding=ShardingConfig(remat=remat),
                    train=TrainConfig(optimizer=OptimizerConfig(
                        lr=1e-3, warmup_steps=2, total_steps=30)))
    step_fn = make_train_step(cfg, run)

    def batch_fn(step):
        x, y = batch_for_step(cfg, shape, step)
        return torch.from_numpy(x), torch.from_numpy(y)

    return cfg, run, step_fn, batch_fn


def _equal_trees(a, b):
    return all(torch.equal(x, y) for x, y in zip(tree.leaves(a),
                                                 tree.leaves(b)))


def test_recovery_matches_uninterrupted(tmp_path):
    cfg, _, step_fn, batch_fn = _setup()
    state = init_train_state(cfg, seed=0, device="cpu")
    for s in range(12):
        state, _ = step_fn(state, *batch_fn(s))
    crashes = {5, 9}

    def hook(step):
        if step in crashes:
            crashes.discard(step)
            raise RuntimeError(f"injected node failure at {step}")

    runner = TrainRunner(step_fn, init_train_state(cfg, seed=0, device="cpu"),
                         batch_fn, Checkpointer(str(tmp_path),
                                                async_save=False),
                         checkpoint_every=4, max_restarts=5,
                         failure_hook=hook)
    report = runner.run(12)
    assert (report.restarts, report.steps_completed) == (2, 12)
    assert _equal_trees(state["master"], runner.state["master"])
    assert _equal_trees(state["opt"], runner.state["opt"])


def test_kill_phases_recover_bitwise(tmp_path):
    """A straggler delay, mid-forward and mid-backward kills and a killed
    async write: the recovered run's loss bits and mask digests are the
    uninterrupted run's, the failed save is counted apart from the
    restarts, every replayed step reproduces its bits, and the digests are
    the JAX recorder's for the same plan."""
    cfg, run, step_fn, batch_fn = _setup()
    plan = DropoutPlan(run.dropout)
    sched = compile_schedule(cfg, run.dropout, 2, 32)
    contract = contract_from_schedule(cfg, sched)
    shape = run.shape

    def recorder():
        return TrajectoryRecorder(plan, shape.global_batch, cfg.n_heads,
                                  shape.seq_len, shape.seq_len,
                                  device="cpu")

    ref = recorder()
    rec_step = ref.wrap_step(step_fn)
    state = init_train_state(cfg, seed=0, device="cpu")
    for s in range(12):
        state, _ = rec_step(state, *batch_fn(s))

    rec = recorder()
    monkey = ChaosMonkey((Fault(3, "delay", delay_s=1.0),
                          Fault(5, "forward"), Fault(7, "backward")))
    ckpt = ChaosCheckpointer(str(tmp_path), kill_steps={8}, async_save=True)
    runner = TrainRunner(monkey.wrap_step(rec.wrap_step(step_fn)),
                         init_train_state(cfg, seed=0, device="cpu"),
                         batch_fn, ckpt, checkpoint_every=4, max_restarts=5,
                         straggler=StragglerDetector(window=16, k=4.0,
                                                     warmup=2),
                         contract=contract, model_cfg=cfg, schedule=sched)
    report = runner.run(12)
    assert (report.steps_completed, report.restarts,
            report.failed_saves) == (12, 2, 1)
    assert ckpt.killed_writes == [8]
    assert monkey.injected == [(3, "delay"), (5, "forward"),
                               (7, "backward")]
    assert report.straggler_steps >= 1 and rec.replays >= 1
    ref.assert_identical(rec)
    assert _equal_trees(state["master"], runner.state["master"])
    jrec = JRecorder(j_plan_from_config(JPlanConfig(mode="overlap", p=0.1)),
                     shape.global_batch, cfg.n_heads, shape.seq_len,
                     shape.seq_len)
    for step in (0, 5, 11):
        assert jrec._digest(step) == rec.mask_digest[step]


# ------------------------------------------------------------ launcher

def _launch(tmp_path, *extra, steps=6):
    return launcher.main(["--arch", "llama2-7b", "--reduced", "--steps",
                          str(steps), "--batch", "2", "--seq", "32",
                          "--ckpt-every", "3", "--log-every", "2",
                          "--ckpt-dir", str(tmp_path), "--device", "cpu",
                          *extra])


def test_launcher_runs_and_resumes(tmp_path, capsys):
    """The launcher on the CPU: a fresh run to step 6, then a resume to 8
    that verifies the contract; a changed site resumes "recompiled"
    (proven by the counter layer), a changed p raises."""
    first = _launch(tmp_path)
    out = capsys.readouterr().out
    assert first.report.steps_completed == 6 and first.contract_status is None
    assert "[train] done: steps=6" in out
    second = _launch(tmp_path, steps=8)
    out = capsys.readouterr().out
    assert "dropout contract verified for step 6" in out
    assert "resuming from step 6" in out
    assert second.resumed_from == 6 and second.report.steps_completed == 8
    run = launcher.build_run(launcher.argparse.Namespace(
        arch="llama2-7b", reduced=True, steps=8, batch=2, seq=32, lr=3e-4,
        microbatch=0, remat="block", dropout="overlap", dropout_p=0.1,
        ckpt_every=3, ckpt_dir=str(tmp_path), seed=0, log_every=2))
    moved = dataclasses.replace(run, dropout=dataclasses.replace(
        run.dropout, site="ffn_up"))
    assert launcher.train(moved, 8, device="cpu").contract_status == \
        "recompiled"
    drifted = dataclasses.replace(run, dropout=dataclasses.replace(
        run.dropout, p=0.2))
    with pytest.raises(ContractMismatchError, match="p:"):
        launcher.train(drifted, 9, device="cpu")


# ---------------------------------------------------------- serve, data

def test_engine_contract_drift_fail_fast():
    """A request whose bucket template moved after admission re-proves its
    contract: a realization drift passes the counter layer
    ("recompiled"), an identity drift raises."""
    eng = ServeEngine(get_arch("yi-6b", reduced=True),
                      serve=ServeConfig(max_slots=2, page_size=16,
                                        num_pages=16, max_model_len=96,
                                        prompt_bucket=8),
                      init_seed=0, device="cpu")
    req = eng.make_request(list(range(10)), 4)
    eng._admission_schedule(req)
    assert req.contract is not None
    assert eng.verify_request_contract(req) == "verified"
    tmpl2 = compile_schedule(eng.cfg, dataclasses.replace(
        eng.plan, site="prev_gemm"), 1, req.mask_seq)
    eng.schedule_buckets.replace(req.bucket, tmpl2)
    assert eng.verify_request_contract(req) == "recompiled"
    assert eng.verify_request_contract(req) == "verified"
    tmpl3 = compile_schedule(eng.cfg, dataclasses.replace(
        eng.plan, philox_rounds=10), 1, req.mask_seq)
    eng.schedule_buckets.replace(req.bucket, tmpl3)
    with pytest.raises(ContractMismatchError):
        eng.verify_request_contract(req)


def test_device_batch_and_prefetcher():
    cfg = get_arch("llama2-7b", reduced=True)
    shape = ShapeConfig("d", seq_len=32, global_batch=2, kind=StepKind.TRAIN)
    x, y = device_batch(cfg, shape, 3, device="cpu")
    wx, wy = batch_for_step(cfg, shape, 3)
    assert np.array_equal(x.numpy(), wx) and np.array_equal(y.numpy(), wy)
    # a rank makes only its rows of a sharded batch, bitwise the whole's
    # (device_batch under a policy: tests/test_torch_multirank.py)
    for rows in ((0, 1), (1, 2)):
        rx, ry = batch_for_step(cfg, shape, 3, rows=rows)
        assert np.array_equal(rx, wx[rows[0]:rows[1]])
        assert np.array_equal(ry, wy[rows[0]:rows[1]])
    pf = Prefetcher(cfg, shape, start_step=5, depth=2, device="cpu")
    try:
        for want in (5, 6, 7):
            step, (bx, _) = next(pf)
            assert step == want
            assert np.array_equal(bx.numpy(),
                                  batch_for_step(cfg, shape, want)[0])
    finally:
        pf.stop()
    assert not pf._thread.is_alive()
