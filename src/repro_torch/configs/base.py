"""Configuration system of the PyTorch port: a copy of ``repro.configs.base``.

Every architecture is a :class:`ModelConfig` built from a small set of
composable block descriptions (attention kind, FFN kind, SSM kind).
``padded_vocab`` and ``reduced()`` are kept identical to the JAX package's,
so parameter shapes, tree paths and bucket keys match between the two.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# Block descriptors
# ---------------------------------------------------------------------------
# A layer is described by a (mixer, ffn) pair:
#   mixer: "gqa" | "mla" | "mamba" | "mlstm" | "slstm"
#   ffn:   "dense" | "moe" | "none"


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2 / MiniCPM3 style)."""

    q_lora_rank: Optional[int] = None  # None => full-rank q projection
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    d_ff_expert: int = 1024
    num_shared: int = 0           # shared (always-on) experts
    capacity_factor: float = 1.25
    router_z_coef: float = 1e-3   # z-loss on router logits
    aux_coef: float = 1e-2        # load-balance auxiliary loss
    # dispatch strategy (perf knob, EXPERIMENTS.md §Perf):
    #   "global"  — one global capacity buffer; scatter across the sharded
    #               token axis costs a dense (E,C,d) all-reduce over data
    #   "per_row" — per-batch-row capacity; dispatch is local, the
    #               batch->expert reshard lowers to an all-to-all
    dispatch: str = "global"


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    # mamba
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0              # 0 => ceil(d_model / 16)
    # xlstm (mlstm / slstm)
    proj_factor: float = 2.0
    chunk_size: int = 128


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 => d_model // n_heads
    # layer pattern: tuple of (mixer, ffn) strings, length == num_layers.
    # Empty => every layer is (default_mixer, default_ffn).
    pattern: Tuple[Tuple[str, str], ...] = ()
    default_mixer: str = "gqa"
    default_ffn: str = "dense"
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    rms_eps: float = 1e-6
    tie_embeddings: bool = False
    mla: Optional[MLAConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # attention implementation: auto | dense | chunked | pallas
    # (perf knob, see EXPERIMENTS.md §Perf; "auto" = chunked above 8k seq)
    attn_impl: str = "auto"
    attn_chunk_q: int = 2048
    attn_chunk_k: int = 2048
    # modality frontend stubs: "none" | "vision" | "audio_frames"
    frontend: str = "none"
    n_frontend_tokens: int = 0     # e.g. 256 SigLIP patch embeddings
    # True when every mixer is full attention => long_500k must be skipped
    # (quadratic attention at 524k); SSM/hybrid archs keep it.
    dtype: str = "bfloat16"

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if not self.pattern:
            object.__setattr__(
                self,
                "pattern",
                tuple((self.default_mixer, self.default_ffn) for _ in range(self.num_layers)),
            )
        assert len(self.pattern) == self.num_layers, (
            f"{self.name}: pattern length {len(self.pattern)} != num_layers {self.num_layers}")

    # ------------------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256 (MXU-aligned, divisible by
        the 16-way model axis) — standard TPU practice; see DESIGN.md."""
        return -(-self.vocab // 256) * 256

    @property
    def full_attention_only(self) -> bool:
        return all(m in ("gqa", "mla") for m, _ in self.pattern)

    @property
    def has_ssm_state(self) -> bool:
        return any(m in ("mamba", "mlstm", "slstm") for m, _ in self.pattern)

    def mixer_kinds(self) -> Sequence[str]:
        return [m for m, _ in self.pattern]

    # ------------------------------------------------------------------
    def reduced(self, **overrides) -> "ModelConfig":
        """A tiny config of the same family for CPU smoke tests."""
        n_layers = min(self.num_layers, 2 if len(set(self.pattern)) <= 1 else 4)
        # keep pattern variety: take a representative slice
        kinds = list(dict.fromkeys(self.pattern))  # unique, ordered
        pattern = tuple((kinds * n_layers)[:n_layers])
        n_heads = min(self.n_heads, 4)
        n_kv = max(1, min(self.n_kv_heads, n_heads))
        while n_heads % n_kv:
            n_kv -= 1
        d_model = 64
        kw = dict(
            name=self.name + "-reduced",
            family=self.family,
            num_layers=n_layers,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=d_model // n_heads,
            d_ff=128,
            vocab=512,
            pattern=pattern,
            default_mixer=self.default_mixer,
            default_ffn=self.default_ffn,
            qk_norm=self.qk_norm,
            rope_theta=self.rope_theta,
            tie_embeddings=self.tie_embeddings,
            mla=MLAConfig(q_lora_rank=(32 if self.mla and self.mla.q_lora_rank else None),
                          kv_lora_rank=32, qk_nope_head_dim=8,
                          qk_rope_head_dim=8, v_head_dim=16) if self.mla else None,
            moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=64,
                          num_shared=min(1, self.moe.num_shared)) if self.moe else None,
            ssm=SSMConfig(d_state=8, d_conv=4, expand=2, chunk_size=8) if self.ssm else None,
            frontend=self.frontend,
            n_frontend_tokens=8 if self.frontend != "none" else 0,
            dtype="float32",
        )
        kw.update(overrides)
        return ModelConfig(**kw)


def cut_layers(cfg: ModelConfig, layers: str) -> ModelConfig:
    """``cfg`` cut in depth to the layers ``start:stop`` of its pattern, every
    width kept: how a model too large for one card is run on it (jamba's
    first group of 8 layers is ``"0:8"``)."""
    start, stop = (int(x) for x in layers.split(":"))
    if not 0 <= start < stop <= cfg.num_layers:
        raise ValueError(f"layers {layers!r} outside {cfg.name}'s {cfg.num_layers}")
    return dataclasses.replace(cfg, num_layers=stop - start, pattern=cfg.pattern[start:stop])


# ---------------------------------------------------------------------------
# Input shapes assigned to this paper (LM-family: seq_len x global_batch)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """long_500k needs sub-quadratic attention; skip for pure-attention archs."""
    if shape.name == "long_500k" and cfg.full_attention_only:
        return False, ("skipped: pure full-attention architecture has no "
                       "sub-quadratic path at 524k context (noted in DESIGN.md)")
    return True, ""


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def _load():
    from repro_torch.configs import all_archs  # noqa: F401


def get_config(name: str) -> ModelConfig:
    _load()
    if name not in _REGISTRY:
        raise KeyError(f"unknown architecture {name!r}; ported: "
                       f"{', '.join(list_configs())}")
    return _REGISTRY[name]


def list_configs():
    _load()
    return sorted(_REGISTRY)
