"""DropoutPlan — where attention-dropout RNG runs, and the seed/salt folding
that names every mask.

  mode "fused"   — inside the attention computation (paper baseline).
  mode "overlap" — at a producer site: packed keep bits are made ahead of
                   attention, which only applies the cheap dropping step.
  mode "none"    — dropout disabled.

Seeds fold (step, layer) into the Philox counters, so a mask is a pure
function of (seed, salt, layer, step) whichever producer makes it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.config.base import DropoutPlanConfig
from repro_torch.core import dropout_rng
from repro_torch.device import DeviceLike
from repro_torch.kernels.philox_common import fold_layer_salt, fold_step_seed

# distinct salt streams so attention masks never collide with residual /
# embedding dropout even at the same (layer, step)
SALT_ATTN = 0x0
SALT_RESID = 0x40000000
SALT_EMBED = 0x7FFF0000


@dataclasses.dataclass(frozen=True)
class DropoutPlan:
    cfg: DropoutPlanConfig

    @property
    def enabled(self) -> bool:
        return self.cfg.enabled

    @property
    def overlapped(self) -> bool:
        return self.cfg.mode == "overlap"

    def salt(self, layer_idx, stream: int = SALT_ATTN) -> torch.Tensor:
        """uint32 salt for (layer, stream), as a 0-d int64 tensor."""
        return torch.tensor(fold_layer_salt(int(layer_idx), stream),
                            dtype=torch.int64)

    def step_seed(self, step) -> torch.Tensor:
        """The step folded into the Philox key, as a 0-d int64 tensor: an
        array seed, so ``split_seed`` keys it with key_hi = 0."""
        return torch.tensor(fold_step_seed(int(step), self.cfg.seed),
                            dtype=torch.int64)

    def precompute_mask(self, batch: int, n_heads: int, sq: int, sk: int,
                        layer_idx, step, device: DeviceLike = None
                        ) -> Optional[torch.Tensor]:
        """Packed keep bits made by the plain producer (overlap mode only);
        None when the plan keeps RNG fused."""
        if not self.enabled or not self.overlapped:
            return None
        return dropout_rng.packed_mask(
            batch, n_heads, sq, sk, self.cfg.p, self.step_seed(step),
            self.salt(layer_idx), self.cfg.philox_rounds,
            self.cfg.philox_bits, device=device)

    def chunk_keep_mask(self, batch: int, n_heads: int, q_start: int,
                        cq: int, sk: int, layer_idx, step,
                        device: DeviceLike = None) -> Optional[torch.Tensor]:
        """Fused mode's keep bits of one attention q-chunk, bool (B, H, cq,
        SK) for query rows [q_start, q_start + cq), drawn where the chunk
        is attended: the same counters, so the same bits, as the packed
        plane's rows. None when the plan is disabled."""
        if not self.enabled:
            return None
        return dropout_rng.keep_mask_block(
            batch, n_heads, q_start, cq, sk, self.cfg.p,
            self.step_seed(step), self.salt(layer_idx),
            self.cfg.philox_rounds, self.cfg.philox_bits, device=device)
