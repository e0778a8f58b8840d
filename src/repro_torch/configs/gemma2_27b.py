"""gemma2-27b [dense]: local+global alternating attention, logit softcaps.

46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000 [arXiv:2408.00118].
head_dim=128; query scale (d_model/n_heads)^-0.5 = 144^-0.5; attn softcap
50, final softcap 30; pre+post RMSNorms; GeGLU.  Local layers decode over
a 4096-slot ring, global layers over the paged pool.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="gemma2_27b",
    n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16, head_dim=128,
    d_ff=36864, vocab=256000,
    pattern=(("local", "mlp"), ("attn", "mlp")),
    window=4096, mlp_type="geglu", norm_type="rmsnorm",
    rope_theta=10000.0, attn_softcap=50.0, final_softcap=30.0,
    attn_scale=(4608 / 32) ** -0.5, post_norms=True,
    embed_scale=True, tied_embeddings=True,
))
