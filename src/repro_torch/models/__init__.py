"""Model layers and entry points of the port (dense global-attention
decoders: the ``("attn", "mlp")`` layer kind)."""
