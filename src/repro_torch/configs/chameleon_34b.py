"""chameleon-34b [vlm]: early-fusion, VQ image tokens.

48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536 [arXiv:2405.09818].
QK-norm, SwiGLU, RMSNorm and an untied LM head.  The VQ image tokenizer
is a stub, as in the JAX package: the inputs are precomputed token/patch
embeddings (``batch["embeddings"]``), so its path is the model-level
``forward``, ``prefill`` and ``decode``; the serving engine takes token
batches only and refuses it.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="chameleon_34b",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=22016, vocab=65536,
    pattern=(("attn", "mlp"),),
    mlp_type="swiglu", norm_type="rmsnorm", qk_norm=True,
    rope_theta=10000.0, frontend_stub=True,
))
