"""qwen1.5-4b [dense]: QKV bias, an untied LM head, the bf16acc format.

40L d_model=2560 20H (MHA kv=20) d_ff=6912 vocab=151936
[hf:Qwen/Qwen1.5 family].  head_dim=128; SwiGLU; rope theta 1e6; bf16
operands and a bf16 accumulator (``format_policy="bf16acc"``) on every
projection GEMM.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen15_4b",
    n_layers=40, d_model=2560, n_heads=20, n_kv_heads=20, head_dim=128,
    d_ff=6912, vocab=151936,
    pattern=(("attn", "mlp"),),
    mlp_type="swiglu", norm_type="rmsnorm", qkv_bias=True,
    rope_theta=1000000.0,
    format_policy="bf16acc",
))
