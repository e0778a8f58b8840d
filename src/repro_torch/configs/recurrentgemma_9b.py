"""recurrentgemma-9b [hybrid]: RG-LRU + local attention, 1:2 pattern.

38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000 [arXiv:2402.19427].
Pattern: (rglru, rglru, local-MQA) tiled; 38 = 12 full periods + 2 tail.
Local layers decode over a 2048-slot ring; RG-LRU layers carry O(1) state.
"""
from repro_torch.configs.base import ArchConfig, RGLRUConfig, register

CONFIG = register(ArchConfig(
    name="recurrentgemma_9b",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, head_dim=256,
    d_ff=12288, vocab=256000,
    pattern=(("rglru", "mlp"), ("rglru", "mlp"), ("local", "mlp")),
    window=2048, mlp_type="geglu", norm_type="rmsnorm",
    rope_theta=10000.0, embed_scale=True, tied_embeddings=True,
    rglru=RGLRUConfig(width=4096, conv_width=4, c=8.0),
))
