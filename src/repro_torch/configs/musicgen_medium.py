"""musicgen-medium [audio]: decoder-only over EnCodec frames.

48L d_model=1536 24H (MHA kv=24) d_ff=6144 vocab=2048 [arXiv:2306.05284].
The EnCodec frontend is a stub, as in the JAX package: the inputs are
precomputed frame embeddings (``batch["embeddings"]``, see
``models.model._inputs_to_x``); the backbone is a LayerNorm + plain GELU
decoder with biases and an untied head (fairseq lineage).  Its path is
the model-level ``forward``, ``prefill`` and ``decode`` over contiguous
caches: the serving engine takes token batches only and refuses it.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="musicgen_medium",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24, head_dim=64,
    d_ff=6144, vocab=2048,
    pattern=(("attn", "mlp"),),
    mlp_type="gelu", norm_type="layernorm", qkv_bias=True, mlp_bias=True,
    rope_theta=10000.0, frontend_stub=True,
))
