"""Checkpoints of the port's train state and the dropout contract that
rides in them (the JAX package's ``checkpoint``)."""
from repro_torch.checkpoint.checkpointer import (
    Checkpointer,
    CheckpointWriteError,
)
from repro_torch.checkpoint.contract import (
    CONTRACT_VERSION,
    ContractMismatchError,
    DropoutContract,
    contract_from_schedule,
    schedule_digest,
    verify_resume,
)

__all__ = [
    "CONTRACT_VERSION",
    "Checkpointer",
    "CheckpointWriteError",
    "ContractMismatchError",
    "DropoutContract",
    "contract_from_schedule",
    "schedule_digest",
    "verify_resume",
]
