"""granite-moe-1b-a400m [moe]: 32 experts, top-8.

24L d_model=1024 16H (GQA kv=8) d_ff_expert=512 vocab=49155
[hf:ibm-granite/granite-3.0-1b-a400m-base].  SwiGLU experts, RMSNorm,
rope theta 1e4, tied embeddings.  The published serving configuration:
int8 projection and expert GEMMs (per-expert, per-channel scales) and
all-to-all expert parallelism (``moe_impl="a2a"``), which needs a device
mesh; with none, :func:`repro_torch.models.moe.dispatch` takes the
capacity-scatter formulation, as the JAX package does on one device.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, register

CONFIG = register(ArchConfig(
    name="granite_moe_1b",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8, head_dim=64,
    d_ff=512, vocab=49155,
    pattern=(("attn", "moe"),),
    mlp_type="swiglu", norm_type="rmsnorm",
    rope_theta=10000.0, tied_embeddings=True,
    moe_impl="a2a",
    format_policy="int8",
    moe=MoEConfig(n_experts=32, top_k=8, d_ff_expert=512),
))
