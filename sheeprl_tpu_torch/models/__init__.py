from sheeprl_tpu_torch.models.blocks import MLP, ConvTranspose, LayerNormGRUCell, get_activation

__all__ = ["MLP", "ConvTranspose", "LayerNormGRUCell", "get_activation"]
