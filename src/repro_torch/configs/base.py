"""Architecture configuration (the port's copy of ``repro.configs.base``).

``ArchConfig`` carries the same fields as the JAX package's, with two
defaults changed: ``gemm_backend`` is ``"kernels"`` (the hand-written
Hopper kernels, the counterpart of JAX's ``"pallas"``; the plain
formulation ``"torch"``, JAX's ``"xla"``, is queued), and ``use_graph``
is False (the ``repro.graph`` IR is queued).
``input_specs`` returns ``(shape, dtype-name)`` tuples instead of
``jax.ShapeDtypeStruct``s.

Registry: ``get_config(name)`` knows the configurations this port serves
so far; the other assigned names raise, naming the ROADMAP item that
ports them.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional, Tuple

__all__ = ["ArchConfig", "MoEConfig", "SSMConfig", "RGLRUConfig",
           "ShapeSpec", "SHAPES", "ARCH_NAMES", "PORTED_ARCHS", "get_config",
           "input_specs"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    width: Optional[int] = None
    conv_width: int = 4
    c: float = 8.0


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    pattern: Tuple[Tuple[str, str], ...] = (("attn", "mlp"),)
    window: Optional[int] = None
    mlp_type: str = "swiglu"
    norm_type: str = "rmsnorm"
    qkv_bias: bool = False
    mlp_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    attn_scale: Optional[float] = None
    post_norms: bool = False
    tied_embeddings: bool = False
    embed_scale: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    frontend_stub: bool = False
    # execution knobs
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    format_policy: Optional[str] = None
    gemm_policy: str = "mte"
    gemm_backend: str = "kernels"           # kernels | torch (queued, A4)
    remat: str = "full"
    scan_layers: bool = True
    moe_impl: str = "scatter"
    attn_chunk: int = 1024
    cache_shard_hd: bool = True
    cache_shard_seq: bool = False
    cache_quant: bool = False
    kv_cache_format: Optional[str] = None
    decode_qkv_grouped: bool = False
    use_graph: bool = False                 # the repro.graph IR is ROADMAP
    #                                         A7; True raises until then

    def __post_init__(self):
        from repro_torch.core.formats import FORMATS

        def require(ok: bool, what: str) -> None:
            if not ok:
                raise ValueError(f"ArchConfig {self.name!r}: {what}")

        require(self.n_heads % self.n_kv_heads == 0,
                f"n_heads {self.n_heads} not a multiple of n_kv_heads "
                f"{self.n_kv_heads}")
        for field in ("format_policy", "kv_cache_format"):
            value = getattr(self, field)
            require(value is None or value in FORMATS,
                    f"unknown {field} {value!r}; known: {sorted(FORMATS)}")
        for mixer, ffn in self.pattern:
            require(mixer in ("attn", "local", "rglru", "ssd"),
                    f"unknown mixer {mixer!r}")
            require(ffn in ("mlp", "moe", "none"), f"unknown ffn {ffn!r}")
            require(mixer != "local" or self.window is not None,
                    "local attention needs window")
            require(ffn != "moe" or self.moe is not None,
                    "a moe layer needs moe")

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def period(self) -> int:
        return len(self.pattern)

    @property
    def layer_kinds(self) -> Tuple[Tuple[str, str], ...]:
        reps = -(-self.n_layers // self.period)
        return (self.pattern * reps)[: self.n_layers]

    @property
    def is_subquadratic(self) -> bool:
        return all(m != "attn" for m, _ in self.pattern)

    def cache_len(self, mixer: str, seq_len: int) -> int:
        if mixer == "local":
            return min(self.window, seq_len)
        return seq_len

    def n_params(self) -> int:
        """Approximate parameter count (dense attention + MLP layers)."""
        d, hd = self.d_model, self.hd
        total = self.vocab * d * (1 if self.tied_embeddings else 2)
        for mixer, ffn in self.layer_kinds:
            if mixer in ("attn", "local"):
                total += d * hd * (self.n_heads + 2 * self.n_kv_heads)
                total += self.n_heads * hd * d
            if ffn == "mlp":
                k = 3 if self.mlp_type in ("swiglu", "geglu") else 2
                total += k * d * self.d_ff
        total += d
        return total

    def reduced(self) -> "ArchConfig":
        """CPU smoke-test configuration of the same family (identical to
        the JAX package's ``reduced()``)."""
        kw = dict(
            n_layers=2 * self.period,
            d_model=128,
            n_heads=4,
            n_kv_heads=max(1, 4 * self.n_kv_heads // self.n_heads),
            head_dim=32,
            d_ff=256,
            vocab=512,
            window=16 if self.window else None,
            compute_dtype="float32",
            format_policy=None,
            remat="none",
        )
        if self.moe:
            kw["moe"] = dataclasses.replace(
                self.moe, n_experts=4, top_k=2, d_ff_expert=64,
                capacity_factor=4.0)
        if self.ssm:
            kw["ssm"] = dataclasses.replace(
                self.ssm, d_state=16, head_dim=16, chunk=8)
        if self.rglru:
            kw["rglru"] = dataclasses.replace(self.rglru, width=128)
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

ARCH_NAMES = [
    "recurrentgemma_9b", "qwen3_moe_235b", "granite_moe_1b",
    "musicgen_medium", "chameleon_34b", "gemma2_27b", "starcoder2_7b",
    "gemma_2b", "qwen15_4b", "mamba2_130m",
]
PORTED_ARCHS = ("gemma_2b",)

_REGISTRY: Dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    name = name.replace("-", "_")
    if name in ARCH_NAMES and name not in PORTED_ARCHS:
        raise NotImplementedError(
            f"config {name!r} is not ported yet (ROADMAP queue A: the "
            f"other nine configs); ported: {list(PORTED_ARCHS)}")
    if name not in _REGISTRY:
        if name not in PORTED_ARCHS:
            raise KeyError(f"unknown config {name!r}")
        importlib.import_module(f"repro_torch.configs.{name}")
    return _REGISTRY[name]


def input_specs(cfg: ArchConfig, shape: ShapeSpec):
    """``(shape, dtype)`` stand-ins for every model input (no allocation)."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        if cfg.frontend_stub:
            return {"embeddings": ((b, s, cfg.d_model), "bfloat16"),
                    "targets": ((b, s), "int32")}
        return {"tokens": ((b, s), "int32")}
    if cfg.frontend_stub:
        return {"embeddings": ((b, 1, cfg.d_model), "bfloat16"),
                "pos": ((), "int32")}
    return {"tokens": ((b, 1), "int32"), "pos": ((), "int32")}
