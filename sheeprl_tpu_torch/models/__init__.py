from sheeprl_tpu_torch.models.blocks import (
    CNN,
    MLP,
    Conv2d,
    ConvTranspose,
    ConvTranspose2d,
    Dense,
    LayerNorm,
    LayerNormGRUCell,
    MultiEncoder,
    NatureCNN,
    get_activation,
    lecun_normal_,
    set_compute_dtype,
)

__all__ = [
    "CNN", "MLP", "Conv2d", "ConvTranspose", "ConvTranspose2d", "Dense", "LayerNorm", "LayerNormGRUCell",
    "MultiEncoder", "NatureCNN", "get_activation", "lecun_normal_", "set_compute_dtype",
]
