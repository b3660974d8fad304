"""Hand-written Hopper kernels, each beside its plain PyTorch version."""

from vqvae2_tpu_torch.ops.quantize import (  # noqa: F401
    nearest_code,
    nearest_code_ids,
    nearest_code_reference,
    quantize_lookup,
)
from vqvae2_tpu_torch.ops.flash_attention import (  # noqa: F401
    causal_attention_reference,
    causal_flash_attention,
)
