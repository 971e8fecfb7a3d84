"""AdamW on f32 master parameters and int8 gradient compression (the JAX
package's ``optim``)."""
from repro_torch.optim.adamw import (
    adamw_init,
    adamw_update,
    global_norm,
    schedule_lr,
)
from repro_torch.optim.compression import (
    compress_tree,
    compressed_allreduce,
    compressed_psum,
    dequantize_int8,
    quantize_int8,
    residual_init,
)

__all__ = ["adamw_init", "adamw_update", "global_norm", "schedule_lr",
           "compress_tree", "compressed_allreduce", "compressed_psum",
           "dequantize_int8", "quantize_int8", "residual_init"]
