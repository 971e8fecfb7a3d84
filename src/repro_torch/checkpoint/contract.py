"""The checkpointed dropout contract: everything a resumed run must
agree on to re-emit in-flight masks bit-identically.

The paper's counter-based scheme makes every mask a pure function of
(seed, salt, layer, step, b, h, q, k), so fault recovery is a provable
replay if the resumed process folds the same seed lineage into the same
counters. This module freezes that lineage next to the params (the JAX
package's ``repro/checkpoint/contract.py``, field for field: for the same
plan and shape the contract's JSON and ``schedule_sha256`` are the JAX
package's byte for byte, so a contract either frozen verifies against the
other's schedule):

  * ``mask_identity`` — the fields the BITS depend on: base seed, keep
    threshold, Philox rounds/width, the salt-folding constants and
    stream bases, and the (model, n_layers) the salts enumerate. A
    mismatch here means the restored optimizer state would train under
    DIFFERENT masks than the ones it was computed with — ``verify_resume``
    refuses, naming the field.
  * ``realization`` — where/how the bits are produced: the schedule
    digest, host site, GEMM dtype, shapes, and mesh topology. Drift here
    is legal (that's the elastic re-mesh path — same bits, new
    producers) but must be proven safe: ``verify_resume`` runs the
    static mask-safety verifier's counter layer (repro_torch.analysis)
    over the new schedule and only then reports "recompiled".

The schedule digest is sha256 over canonical JSON: Python's ``hash()``
is process-salted (PYTHONHASHSEED) and would make every restart look
like a contract violation.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Dict, Optional

CONTRACT_VERSION = 1


class ContractMismatchError(RuntimeError):
    """A resumed run's dropout contract disagrees with the checkpoint's
    on a mask-bit-defining field: replaying would train the restored
    params under different masks. Fix the run config (the error names
    the field) or start a fresh run."""


def schedule_digest(sched) -> str:
    """Stable content hash of a compiled DropoutSchedule: sha256 over
    the canonical JSON of its machine-readable summary plus the plan
    knobs the summary elides. Identical across processes and restarts
    (unlike ``hash()``); two schedules with equal digests plan the same
    producers for the same bits."""
    p = sched.plan
    doc = {
        "summary": sched.summary(),
        "plan": {
            "mode": p.mode, "p": p.p, "seed": p.seed,
            "philox_rounds": p.philox_rounds,
            "philox_bits": p.philox_bits,
            "site": p.site, "gemm_dtype": p.gemm_dtype,
        },
    }
    blob = json.dumps(doc, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


@dataclasses.dataclass(frozen=True)
class DropoutContract:
    """Frozen record of one run's mask lineage; saved with every
    checkpoint, verified on every restore."""
    mask_identity: Dict
    realization: Dict
    version: int = CONTRACT_VERSION

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @staticmethod
    def from_json(blob: str) -> "DropoutContract":
        doc = json.loads(blob)
        return DropoutContract(
            mask_identity=doc["mask_identity"],
            realization=doc["realization"],
            version=doc.get("version", CONTRACT_VERSION))


def contract_from_schedule(cfg, sched) -> DropoutContract:
    """Distill (model config, compiled schedule) into the contract. The
    identity half folds in the salt constants themselves, so a code
    change to the folding scheme is caught as a contract violation, not
    silently replayed with different bits."""
    from repro_torch.core.overlap import SALT_ATTN, SALT_EMBED, SALT_RESID
    from repro_torch.kernels.philox_common import (
        LAYER_SALT_PRIME,
        STEP_SEED_MULT,
        threshold_from_p,
    )
    p = sched.plan
    identity = {
        "mode": p.mode,
        "seed": p.seed,
        "p": p.p,
        "threshold": threshold_from_p(p.p),
        "philox_rounds": p.philox_rounds,
        "philox_bits": p.philox_bits,
        "layer_salt_prime": LAYER_SALT_PRIME,
        "step_seed_mult": STEP_SEED_MULT,
        "salt_streams": {"attn": SALT_ATTN, "resid": SALT_RESID,
                         "embed": SALT_EMBED},
        "model": sched.model,
        "n_layers": cfg.n_layers,
    }
    realization = {
        "schedule_sha256": schedule_digest(sched),
        "site": p.site,
        "resolved_site": sched.resolved_site,
        "gemm_dtype": p.gemm_dtype,
        "attn_impl": sched.attn_impl,
        "batch": sched.batch,
        "seq": sched.seq,
        "shards": [sched.shard.batch_shards, sched.shard.head_shards],
        "carried": sched.carried,
        "moe_seq_dispatch": sched.moe_seq_dispatch,
    }
    return DropoutContract(mask_identity=identity,
                           realization=realization)


def verify_resume(saved: DropoutContract, current: DropoutContract,
                  cfg=None, sched=None) -> str:
    """Gate a restore on the dropout contract.

    Returns "verified" when the contracts agree exactly: the resumed
    run replays the in-flight masks from the identical schedule.

    On a ``realization``-only drift (new topology, different host site:
    same bits, different producers) the new schedule must prove itself:
    pass ``cfg``/``sched`` and the static mask-safety verifier lints it
    (MS-C1/C2 counter disjointness, MS-C4 shard-window tiling for the
    new mesh); returns "recompiled" on success, raises MaskSafetyError
    on findings, raises ContractMismatchError when the proof inputs are
    missing.

    A ``mask_identity`` mismatch always raises ContractMismatchError
    naming each drifted field: those fields define the bits, and
    silently resuming would train the restored params under masks they
    were never computed with."""
    drift = [k for k in set(saved.mask_identity)
             | set(current.mask_identity)
             if saved.mask_identity.get(k) !=
             current.mask_identity.get(k)]
    if drift:
        lines = [
            f"  {k}: checkpoint={saved.mask_identity.get(k)!r} "
            f"run={current.mask_identity.get(k)!r}"
            for k in sorted(drift)]
        raise ContractMismatchError(
            "dropout contract violation: the resumed run would generate "
            "DIFFERENT mask bits than the checkpointed trajectory "
            "(mask_identity fields drifted):\n" + "\n".join(lines)
            + "\nAlign the run config with the checkpoint (same seed, "
            "p, philox knobs, model) or start a fresh run directory.")
    if saved.realization == current.realization:
        return "verified"
    if cfg is None or sched is None:
        changed = [k for k in set(saved.realization)
                   | set(current.realization)
                   if saved.realization.get(k) !=
                   current.realization.get(k)]
        raise ContractMismatchError(
            "dropout realization drifted "
            f"({', '.join(sorted(changed))}) and no compiled schedule "
            "was provided to re-verify — pass cfg/sched so the new "
            "realization can be proven mask-safe (repro_torch.analysis).")
    from repro_torch.analysis import verify_schedule
    verify_schedule(cfg, sched)       # raises MaskSafetyError on findings
    return "recompiled"
