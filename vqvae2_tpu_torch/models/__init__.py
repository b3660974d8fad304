"""Model zoo (``nn.Module``s, ``(B, H, W, C)`` at every public function)."""

from vqvae2_tpu_torch.models.vqvae import (  # noqa: F401
    VQVAE,
    Decoder,
    Encoder,
    Quantize,
    ResBlock,
    build_vqvae,
)
from vqvae2_tpu_torch.models.pixelsnail import (  # noqa: F401
    CausalAttention,
    CausalConv,
    CondResNet,
    GatedResBlock,
    PixelBlock,
    PixelSNAIL,
    WNConv,
    WNDense,
)
