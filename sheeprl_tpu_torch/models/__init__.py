from sheeprl_tpu_torch.models.blocks import MLP, LayerNormGRUCell, get_activation

__all__ = ["MLP", "LayerNormGRUCell", "get_activation"]
