"""Assigned architecture configs. Importing this package registers every
arch with the registry, making them selectable via ``--arch <id>``."""
from repro_torch.configs import (  # noqa: F401
    arctic_480b,
    chameleon_34b,
    command_r_35b,
    gpt3_175b,
    llama2_7b,
    moonshot_v1_16b_a3b,
    musicgen_large,
    qwen2_72b,
    qwen3_8b,
    recurrentgemma_9b,
    rwkv6_7b,
    yi_6b,
)
