"""qwen3-moe-235b-a22b [moe]: 128 experts, top-8.

94L d_model=4096 64H (GQA kv=4) d_ff_expert=1536 vocab=151936
[hf:Qwen/Qwen3-30B-A3B family].  QK-norm per the Qwen3 family; SwiGLU
experts, RMSNorm, rope theta 1e6, an untied LM head.  Its 235 B
parameters need more than one card: the port runs it ``reduced()``
(ROADMAP A12 for full width).
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, register

CONFIG = register(ArchConfig(
    name="qwen3_moe_235b",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, head_dim=128,
    d_ff=1536, vocab=151936,
    pattern=(("attn", "moe"),),
    mlp_type="swiglu", norm_type="rmsnorm", qk_norm=True,
    rope_theta=1000000.0,
    moe_impl="a2a",
    moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=1536),
))
