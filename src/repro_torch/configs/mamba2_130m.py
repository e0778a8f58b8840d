"""mamba2-130m [ssm]: SSD (state-space duality), attention-free.

24L d_model=768 ssm_state=128 vocab=50280 [arXiv:2405.21060].
d_inner = 2·768 = 1536, head_dim 64 → 24 SSD heads; conv width 4;
chunk 256.  Every layer is an SSD mixer with no FFN (``("ssd",
"none")``); a slot's decode state is O(1) in the sequence length.  The
SSD block is plain PyTorch (:mod:`repro_torch.models.ssm`), as the JAX
package computes it in plain jnp: no kernel of the port runs on it.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig, register

CONFIG = register(ArchConfig(
    name="mamba2_130m",
    n_layers=24, d_model=768, n_heads=24, n_kv_heads=24, head_dim=64,
    d_ff=0, vocab=50280,
    pattern=(("ssd", "none"),),
    norm_type="rmsnorm", tied_embeddings=True,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, conv_width=4,
                  chunk=256),
))
