"""starcoder2-7b [dense]: GQA + RoPE, sliding-window attention.

32L d_model=4608 36H (GQA kv=4) d_ff=18432 vocab=49152 [arXiv:2402.19173].
Sliding window 4096 on every layer; LayerNorm (with a bias) and the plain
(non-gated) GELU MLP with biases; QKV biases (``o`` has none, as in the
JAX package); an untied LM head; rope theta 1e6.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="starcoder2_7b",
    n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4, head_dim=128,
    d_ff=18432, vocab=49152,
    pattern=(("local", "mlp"),),
    window=4096, mlp_type="gelu", norm_type="layernorm",
    qkv_bias=True, mlp_bias=True, rope_theta=1000000.0,
))
