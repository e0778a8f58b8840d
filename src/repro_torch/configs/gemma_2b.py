"""gemma-2b [dense]: GeGLU, head_dim=256, MQA.

18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=256000 [arXiv:2403.08295].
Embedding scaled by sqrt(d_model); tied LM head.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="gemma_2b",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
    d_ff=16384, vocab=256000,
    pattern=(("attn", "mlp"),),
    mlp_type="geglu", norm_type="rmsnorm",
    rope_theta=10000.0, embed_scale=True, tied_embeddings=True,
    # bf16 operands / f32 accumulation on every projection.
    format_policy="bf16",
))
