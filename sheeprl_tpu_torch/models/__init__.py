from sheeprl_tpu_torch.models.blocks import (
    CNN,
    MLP,
    ConvTranspose,
    LayerNormGRUCell,
    MultiEncoder,
    NatureCNN,
    get_activation,
    lecun_normal_,
)

__all__ = ["CNN", "MLP", "ConvTranspose", "LayerNormGRUCell", "MultiEncoder", "NatureCNN", "get_activation", "lecun_normal_"]
