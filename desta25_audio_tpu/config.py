"""Configuration system for the DeSTA2.5-Audio framework.

Mirrors the reference config surface (``desta/models/modeling_desta25.py:633-694``,
``DeSTA25Config``) but is hub-free: model hyper-parameters for the known
encoder/LLM model ids are baked in as presets so that configs resolve without
network access. Unknown ids raise with a clear message.

All configs are frozen dataclasses — they are hashable so they can be closed
over by ``jax.jit``-compiled functions as static arguments.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


# ---------------------------------------------------------------------------
# Whisper encoder / decoder configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class WhisperConfig:
    """Architecture of a Whisper speech model (encoder + decoder).

    Field names follow the HF ``WhisperConfig`` so checkpoint conversion is
    mechanical.  Reference uses the encoder via
    ``WhisperPerception.forward_whisper`` (modeling_desta25.py:544-627) and the
    decoder only for ASR-in-the-loop (modeling_desta25.py:1581-1601).
    """

    model_id: str = "openai/whisper-large-v3"
    num_mel_bins: int = 128
    d_model: int = 1280
    encoder_layers: int = 32
    encoder_attention_heads: int = 20
    encoder_ffn_dim: int = 5120
    decoder_layers: int = 32
    decoder_attention_heads: int = 20
    decoder_ffn_dim: int = 5120
    vocab_size: int = 51866
    max_source_positions: int = 1500
    max_target_positions: int = 448
    # Special decoder token ids (HF generation_config equivalents).
    decoder_start_token_id: int = 50258  # <|startoftranscript|>
    eos_token_id: int = 50257  # <|endoftext|>
    no_timestamps_token_id: int = 50364
    transcribe_token_id: int = 50360
    first_language_token_id: int = 50259  # <|en|>; languages occupy a block
    num_language_tokens: int = 100

    @property
    def head_dim(self) -> int:
        return self.d_model // self.encoder_attention_heads

    @property
    def expected_mel_frames(self) -> int:
        # conv1 stride 1 * conv2 stride 2 * max_source_positions
        # (modeling_desta25.py:555-560)
        return self.max_source_positions * 2


# Known Whisper variants (dims match the HF checkpoints of the same name).
_WHISPER_PRESETS: Dict[str, Dict[str, Any]] = {
    "openai/whisper-tiny": dict(
        num_mel_bins=80, d_model=384, encoder_layers=4, encoder_attention_heads=6,
        encoder_ffn_dim=1536, decoder_layers=4, decoder_attention_heads=6,
        decoder_ffn_dim=1536, vocab_size=51865,
        decoder_start_token_id=50258, eos_token_id=50257,
        no_timestamps_token_id=50363, transcribe_token_id=50359,
        first_language_token_id=50259, num_language_tokens=99,
    ),
    "openai/whisper-small": dict(
        num_mel_bins=80, d_model=768, encoder_layers=12, encoder_attention_heads=12,
        encoder_ffn_dim=3072, decoder_layers=12, decoder_attention_heads=12,
        decoder_ffn_dim=3072, vocab_size=51865,
        decoder_start_token_id=50258, eos_token_id=50257,
        no_timestamps_token_id=50363, transcribe_token_id=50359,
        first_language_token_id=50259, num_language_tokens=99,
    ),
    "openai/whisper-medium": dict(
        num_mel_bins=80, d_model=1024, encoder_layers=24, encoder_attention_heads=16,
        encoder_ffn_dim=4096, decoder_layers=24, decoder_attention_heads=16,
        decoder_ffn_dim=4096, vocab_size=51865,
        decoder_start_token_id=50258, eos_token_id=50257,
        no_timestamps_token_id=50363, transcribe_token_id=50359,
        first_language_token_id=50259, num_language_tokens=99,
    ),
    "openai/whisper-large-v3": dict(
        num_mel_bins=128, d_model=1280, encoder_layers=32, encoder_attention_heads=20,
        encoder_ffn_dim=5120, decoder_layers=32, decoder_attention_heads=20,
        decoder_ffn_dim=5120, vocab_size=51866,
    ),
    "openai/whisper-large-v3-turbo": dict(
        num_mel_bins=128, d_model=1280, encoder_layers=32, encoder_attention_heads=20,
        encoder_ffn_dim=5120, decoder_layers=4, decoder_attention_heads=20,
        decoder_ffn_dim=5120, vocab_size=51866,
    ),
    # Tensor-parallel-friendly tiny config (heads/ffn divisible by a
    # 4-way "model" mesh axis) for multi-chip dry runs.
    "test/whisper-dryrun": dict(
        num_mel_bins=80, d_model=128, encoder_layers=4,
        encoder_attention_heads=4, encoder_ffn_dim=256, decoder_layers=2,
        decoder_attention_heads=4, decoder_ffn_dim=256, vocab_size=256,
        max_source_positions=150, max_target_positions=64,
        decoder_start_token_id=250, eos_token_id=251,
        no_timestamps_token_id=254, transcribe_token_id=253,
        first_language_token_id=252, num_language_tokens=1,
    ),
    # 6-layer variant: selected taps (4) != total layers (6), for
    # checkpoint layer-count reconfiguration tests.
    "test/whisper-nano6": dict(
        num_mel_bins=80, d_model=64, encoder_layers=6, encoder_attention_heads=2,
        encoder_ffn_dim=128, decoder_layers=2, decoder_attention_heads=2,
        decoder_ffn_dim=128, vocab_size=256, max_source_positions=150,
        max_target_positions=64,
        decoder_start_token_id=250, eos_token_id=251,
        no_timestamps_token_id=254, transcribe_token_id=253,
        first_language_token_id=252, num_language_tokens=1,
    ),
    # Hub-free tiny config for unit tests (not an HF model).  150 source
    # positions = 300 mel frames (3 s window) keeps CPU tests fast.
    "test/whisper-nano": dict(
        num_mel_bins=80, d_model=64, encoder_layers=4, encoder_attention_heads=2,
        encoder_ffn_dim=128, decoder_layers=2, decoder_attention_heads=2,
        decoder_ffn_dim=128, vocab_size=256, max_source_positions=150,
        max_target_positions=64,
        decoder_start_token_id=250, eos_token_id=251,
        no_timestamps_token_id=254, transcribe_token_id=253,
        first_language_token_id=252, num_language_tokens=1,
    ),
}

# Layer-tap table: which encoder layers feed the connector
# (modeling_desta25.py:134-145).
TARGET_LAYER_IDS: Dict[str, Tuple[int, ...]] = {
    "openai/whisper-medium": (5, 11, 17, 23),
    "openai/whisper-small": (2, 5, 8, 11),
    "openai/whisper-tiny": (0, 1, 2, 3),
    "openai/whisper-large-v3": (7, 15, 23, 31),
    "openai/whisper-large-v3-turbo": (7, 15, 23, 31),
    "test/whisper-nano": (0, 1, 2, 3),
    "test/whisper-nano6": (0, 2, 3, 5),
    "test/whisper-dryrun": (0, 1, 2, 3),
}


def whisper_config_for(model_id: str) -> WhisperConfig:
    if model_id not in _WHISPER_PRESETS:
        raise NotImplementedError(
            f"encoder model_id {model_id!r} not implemented; known: "
            f"{sorted(_WHISPER_PRESETS)}"
        )
    return WhisperConfig(model_id=model_id, **_WHISPER_PRESETS[model_id])


# ---------------------------------------------------------------------------
# LLM config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RopeScalingConfig:
    """Llama-3.1 style NTK rope scaling."""

    rope_type: str = "llama3"
    factor: float = 8.0
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_max_position_embeddings: int = 8192


@dataclass(frozen=True)
class LLMConfig:
    """Decoder-only LLM architecture (Llama-3.x / Qwen3 family)."""

    model_id: str = "meta-llama/Llama-3.1-8B-Instruct"
    vocab_size: int = 128256
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    head_dim: int = 128
    rms_norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    rope_scaling: Optional[RopeScalingConfig] = field(
        default_factory=RopeScalingConfig
    )
    tie_word_embeddings: bool = False
    qk_norm: bool = False  # Qwen3-style per-head RMSNorm on q/k
    attention_bias: bool = False
    max_position_embeddings: int = 131072
    bos_token_id: int = 128000
    eos_token_id: int = 128009  # <|eot_id|> for instruct llama
    chat_template: str = "llama3"  # "llama3" | "qwen3"


_LLM_PRESETS: Dict[str, Dict[str, Any]] = {
    "meta-llama/Llama-3.1-8B-Instruct": dict(),
    # Reference uses a mirror id (desta25_llama31-8B_Qformer6L.yaml:36).
    "DeSTA-ntu/Llama-3.1-8B-Instruct": dict(),
    "Qwen/Qwen3-0.6B": dict(
        vocab_size=151936, hidden_size=1024, intermediate_size=3072,
        num_hidden_layers=28, num_attention_heads=16, num_key_value_heads=8,
        head_dim=128, rms_norm_eps=1e-6, rope_theta=1000000.0,
        rope_scaling=None, tie_word_embeddings=True, qk_norm=True,
        max_position_embeddings=40960, bos_token_id=151643,
        eos_token_id=151645, chat_template="qwen3",
    ),
    "Qwen/Qwen3-4B": dict(
        vocab_size=151936, hidden_size=2560, intermediate_size=9728,
        num_hidden_layers=36, num_attention_heads=32, num_key_value_heads=8,
        head_dim=128, rms_norm_eps=1e-6, rope_theta=1000000.0,
        rope_scaling=None, tie_word_embeddings=True, qk_norm=True,
        max_position_embeddings=40960, bos_token_id=151643,
        eos_token_id=151645, chat_template="qwen3",
    ),
    "Qwen/Qwen3-4B-Instruct-2507": dict(
        vocab_size=151936, hidden_size=2560, intermediate_size=9728,
        num_hidden_layers=36, num_attention_heads=32, num_key_value_heads=8,
        head_dim=128, rms_norm_eps=1e-6, rope_theta=5000000.0,
        rope_scaling=None, tie_word_embeddings=True, qk_norm=True,
        max_position_embeddings=262144, bos_token_id=151643,
        eos_token_id=151645, chat_template="qwen3",
    ),
    # Tensor-parallel-friendly tiny config for multi-chip dry runs.
    "test/llama-dryrun": dict(
        vocab_size=512, hidden_size=128, intermediate_size=256,
        num_hidden_layers=2, num_attention_heads=8, num_key_value_heads=4,
        head_dim=16, rope_theta=10000.0, rope_scaling=None,
        max_position_embeddings=2048, bos_token_id=1, eos_token_id=2,
        chat_template="llama3",
    ),
    # Hub-free tiny config for unit tests.
    "test/llama-nano": dict(
        vocab_size=512, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        head_dim=16, rope_theta=10000.0, rope_scaling=None,
        max_position_embeddings=2048, bos_token_id=1, eos_token_id=2,
        chat_template="llama3",
    ),
    "test/llama-nano128": dict(
        # nano with the flagships' head dim (Dh=128): decode, verify
        # and injection tests at the real per-head width
        vocab_size=512, hidden_size=512, intermediate_size=768,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        head_dim=128, rope_theta=10000.0, rope_scaling=None,
        max_position_embeddings=2048, bos_token_id=1, eos_token_id=2,
        chat_template="llama3",
    ),
    "test/qwen3-nano": dict(
        vocab_size=512, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        head_dim=16, rope_theta=10000.0, rope_scaling=None,
        tie_word_embeddings=True, qk_norm=True,
        max_position_embeddings=2048, bos_token_id=1, eos_token_id=2,
        chat_template="qwen3",
    ),
}


def llm_config_for(model_id: str) -> LLMConfig:
    if model_id not in _LLM_PRESETS:
        raise NotImplementedError(
            f"llm model_id {model_id!r} not implemented; known: "
            f"{sorted(_LLM_PRESETS)}"
        )
    return LLMConfig(model_id=model_id, **_LLM_PRESETS[model_id])


# ---------------------------------------------------------------------------
# Q-Former config (BERT-encoder equivalent)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class QFormerConfig:
    """BERT-style cross-attention transformer used as the connector.

    Matches the reference's ``BertConfig()`` defaults with overridden
    hidden_size / heads / layers (modeling_desta25.py:154-164): intermediate
    size stays at BERT's default 3072 regardless of hidden size, post-LN
    residual structure, GELU, LayerNorm eps 1e-12, bidirectional self-attn
    over the queries plus cross-attn to the encoder states.
    """

    hidden_size: int = 1280
    num_hidden_layers: int = 6
    num_attention_heads: int = 20
    intermediate_size: int = 3072
    layer_norm_eps: float = 1e-12


# ---------------------------------------------------------------------------
# Top-level DeSTA2.5 config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DeSTA25Config:
    """Top-level model config (reference: modeling_desta25.py:633-694)."""

    llm_model_id: str = "DeSTA-ntu/Llama-3.1-8B-Instruct"
    encoder_model_id: str = "openai/whisper-large-v3"
    connector_mode: str = "qformer_1"  # "qformer_1" | "orca_hybrid"
    qformer_num_hidden_layers: int = 2
    prompt_size: int = 64
    # LoRA knobs (reference peft config: r=16, alpha=16, dropout=0.1 on
    # q/k/v_proj — modeling_desta25.py:720-729).  Effective delta is
    # ``(alpha / rank) * B @ A @ dropout(x)`` (peft scaling semantics).
    use_lora: bool = False
    lora_rank: int = 16
    lora_alpha: float = 16.0
    lora_dropout: float = 0.1
    audio_locator: str = "<|AUDIO|>"
    placeholder_token: str = "<|reserved_special_token_87|>"

    # ORCA-DeSTA fields (modeling_desta25.py:645-659).
    orca_enabled: bool = False
    orca_use_all_layers: bool = False
    orca_local_enabled: bool = True
    orca_global_cross_attn: bool = False
    orca_deep_injection_enabled: bool = True
    orca_audio_position_scale: float = 2.5
    orca_global_num_tokens: int = 4
    orca_local_downsample: int = 4
    orca_local_kernel_size: int = 5
    orca_gate_init: float = 0.1
    orca_ortho_weight_global: float = 0.01
    orca_ortho_diversity_weight: float = 0.01
    orca_ortho_weight_qformer_local: float = 0.01
    orca_align_weight_local: float = 0.05
    # Param dtype for the deep-injection cross-attn stack.  f32 matches
    # the reference; "bfloat16" halves params, grad temporaries AND
    # optimizer stats (4*d_model^2 per LLM layer).  Trade-off: optax
    # stores adafactor's factored second moments in the param dtype, so
    # bf16 also coarsens the optimizer statistics — prefer f32 + a
    # "data"-sharded mesh when more than one device is available.
    orca_xattn_dtype: str = "float32"

    # Compute dtype for the frozen towers ("bfloat16" | "float32").
    dtype: str = "bfloat16"
    # Weight-only quantization for the frozen LLM ("none" | "int8"):
    # halves the weight bytes each decode step reads (ops/quant.py).
    llm_quant: str = "none"
    # Activation-dynamic int8 for the frozen whisper encoder ("auto" |
    # "none" | "int8"): int8 x int8 matmuls (twice the bf16 tensor-core
    # rate) with per-token activation scales (W8A8, numerics <=2% of
    # scale).  "auto" (default) resolves to int8 at the inference
    # entrypoints (from_pretrained -> generate/serve/evaluate) and to
    # none for training
    # and direct construction, so training numerics and parity tests
    # match the bf16 reference.  The encoder never trains either way.
    encoder_quant: str = "auto"
    # Weight-only int8 for the ORCA gated cross-attention stack ("none"
    # | "int8").  INFERENCE ONLY (the stack normally trains): halves
    # the per-step injection weight stream.
    orca_xattn_quant: str = "none"
    # Depth cuts (None = the preset's depth): fewer LLM decoder layers /
    # Whisper encoder layers at the preset's widths, for smoke runs and
    # compile checks with random weights.  The connector's encoder taps
    # keep their relative depths.
    llm_num_hidden_layers: Optional[int] = None
    encoder_num_layers: Optional[int] = None

    def resolved_encoder_quant(self, inference: bool) -> str:
        """Resolve encoder_quant="auto": int8 on the inference path
        (from_pretrained), none for training / direct construction."""
        if self.encoder_quant == "auto":
            return "int8" if inference else "none"
        return self.encoder_quant

    @property
    def lora_scale(self) -> float:
        """peft scaling: alpha / r (modeling_desta25.py:720-729)."""
        return self.lora_alpha / max(self.lora_rank, 1)

    @property
    def llm_config(self) -> LLMConfig:
        cfg = llm_config_for(self.llm_model_id)
        if self.llm_num_hidden_layers:
            cfg = dataclasses.replace(
                cfg, num_hidden_layers=self.llm_num_hidden_layers)
        return cfg

    @property
    def encoder_config(self) -> WhisperConfig:
        cfg = whisper_config_for(self.encoder_model_id)
        if self.encoder_num_layers:
            cfg = dataclasses.replace(cfg,
                                      encoder_layers=self.encoder_num_layers)
        return cfg

    @property
    def is_orca(self) -> bool:
        return self.orca_enabled or self.connector_mode == "orca_hybrid"

    @property
    def target_layer_ids(self) -> Tuple[int, ...]:
        if self.is_orca and self.orca_use_all_layers:
            return tuple(range(self.encoder_config.encoder_layers))
        if self.encoder_model_id not in TARGET_LAYER_IDS:
            raise NotImplementedError(
                f"no target layer table for {self.encoder_model_id!r}"
            )
        taps = TARGET_LAYER_IDS[self.encoder_model_id]
        full = whisper_config_for(self.encoder_model_id).encoder_layers
        n = self.encoder_config.encoder_layers
        if n == full:
            return taps
        cut = tuple(round((t + 1) * n / full) - 1 for t in taps)
        if len(set(cut)) != len(taps) or min(cut) < 0:
            raise ValueError(f"encoder_num_layers={n} cannot hold the "
                             f"{len(taps)} connector taps {taps}")
        return cut

    @property
    def audio_token_size(self) -> int:
        """Number of audio tokens spliced per clip (modeling_desta25.py:1575-1580)."""
        if self.connector_mode == "orca_hybrid":
            return self.orca_global_num_tokens
        return self.prompt_size

    @property
    def qformer_config(self) -> QFormerConfig:
        enc = self.encoder_config
        return QFormerConfig(
            hidden_size=enc.d_model,
            num_hidden_layers=self.qformer_num_hidden_layers,
            num_attention_heads=enc.encoder_attention_heads,
        )

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["model_type"] = "desta25"
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "DeSTA25Config":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @classmethod
    def from_json(cls, s: str) -> "DeSTA25Config":
        return cls.from_dict(json.loads(s))


def config_from_yaml_model_section(model_cfg: Dict[str, Any]) -> DeSTA25Config:
    """Build a DeSTA25Config from the reference YAML ``model:`` section.

    Preserves the reference schema (examples/train/config/*.yaml and
    train_desta.py:96-130): ``model.llm.model_id``, ``model.encoder.model_id``,
    ``model.connector.{mode,prompt_size,num_hidden_layers}``,
    ``model.placeholder_token``, ``model.audio_locator``, plus optional
    ``model.orca.*`` / ``model.lora`` fields.
    """
    connector = model_cfg.get("connector", {})
    kwargs: Dict[str, Any] = dict(
        llm_model_id=model_cfg["llm"]["model_id"],
        encoder_model_id=model_cfg["encoder"]["model_id"],
        connector_mode=connector.get("mode", "qformer_1"),
        prompt_size=connector.get("prompt_size", 64),
        qformer_num_hidden_layers=connector.get("num_hidden_layers", 2),
        audio_locator=model_cfg.get("audio_locator", "<|AUDIO|>"),
        placeholder_token=model_cfg.get(
            "placeholder_token", "<|reserved_special_token_87|>"
        ),
        use_lora=model_cfg.get("use_lora", False),
    )
    for k in ("lora_rank", "lora_alpha", "lora_dropout"):
        if k in model_cfg:
            kwargs[k] = model_cfg[k]
    orca = model_cfg.get("orca", {})
    for k, v in orca.items():
        key = f"orca_{k}" if not k.startswith("orca_") else k
        kwargs[key] = v
    # Also accept flat orca_* keys at the model level (ablation overrides).
    for k, v in model_cfg.items():
        if k.startswith("orca_"):
            kwargs[k] = v
    if "dtype" in model_cfg:
        kwargs["dtype"] = model_cfg["dtype"]
    quant = model_cfg.get("llm", {}).get("quant", model_cfg.get("llm_quant"))
    if quant:
        kwargs["llm_quant"] = quant
    enc_quant = model_cfg.get("encoder", {}).get(
        "quant", model_cfg.get("encoder_quant"))
    if enc_quant:
        kwargs["encoder_quant"] = enc_quant
    return DeSTA25Config(**kwargs)
