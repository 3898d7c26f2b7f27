"""Trainable-only checkpoint I/O, reference-key compatible.

The reference saves only ``requires_grad`` params to ``model.safetensors``
(modeling_desta25.py:1284-1292) with torch key names like
``perception.connector.qformer.layer.0.attention.self.query.weight``.  This
module maps between those keys (torch [out, in] layout) and our JAX trees,
so checkpoints interop in both directions:

- a reference checkpoint loads into this framework
  (:func:`load_trainable_safetensors`);
- a model trained here exports a reference-loadable file
  (:func:`save_trainable_safetensors`).

Frozen towers (Whisper/LLM) are loaded from local HF-format checkpoint
dirs via :func:`load_frozen_tower` — layout ``weights_root/<model_id>/``
containing ``*.safetensors`` (the hub layout, pre-downloaded).
"""

from __future__ import annotations

import logging
import os
from typing import Any, Dict, Optional

import jax.numpy as jnp
import numpy as np

from ..config import DeSTA25Config

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# qformer connector <-> reference keys
# ---------------------------------------------------------------------------

_BERT_ATTN = {
    "self.query": ("q",),
    "self.key": ("k",),
    "self.value": ("v",),
    "output.dense": ("o",),
}


def _qformer_to_ref(connector: Dict[str, Any]) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    pre = "perception.connector"
    lp = np.asarray(connector["layer_prompts"], np.float32)
    for i in range(lp.shape[0]):
        out[f"{pre}.layer_prompts.{i}"] = lp[i:i + 1]  # [1, K, d]
    out[f"{pre}.layer_weights"] = np.asarray(connector["layer_weights"],
                                             np.float32)

    # layers is a stacked tree: every leaf has a leading layer axis
    layers = connector["qformer"]["layers"]
    n = int(np.asarray(layers["inter"]["w"]).shape[0])

    def put_attn(i, block, ref_block):
        for hf_name, path in _BERT_ATTN.items():
            sub = block[path[0]]
            out[f"{pre}.qformer.layer.{i}.{ref_block}.{hf_name}.weight"] = \
                np.asarray(sub["w"], np.float32)[i].T
            out[f"{pre}.qformer.layer.{i}.{ref_block}.{hf_name}.bias"] = \
                np.asarray(sub["b"], np.float32)[i]
        out[f"{pre}.qformer.layer.{i}.{ref_block}.output.LayerNorm.weight"] \
            = np.asarray(block["ln"]["scale"], np.float32)[i]
        out[f"{pre}.qformer.layer.{i}.{ref_block}.output.LayerNorm.bias"] \
            = np.asarray(block["ln"]["bias"], np.float32)[i]

    for i in range(n):
        put_attn(i, layers["self"], "attention")
        put_attn(i, layers["cross"], "crossattention")
        out[f"{pre}.qformer.layer.{i}.intermediate.dense.weight"] = \
            np.asarray(layers["inter"]["w"], np.float32)[i].T
        out[f"{pre}.qformer.layer.{i}.intermediate.dense.bias"] = \
            np.asarray(layers["inter"]["b"], np.float32)[i]
        out[f"{pre}.qformer.layer.{i}.output.dense.weight"] = \
            np.asarray(layers["out"]["w"], np.float32)[i].T
        out[f"{pre}.qformer.layer.{i}.output.dense.bias"] = \
            np.asarray(layers["out"]["b"], np.float32)[i]
        out[f"{pre}.qformer.layer.{i}.output.LayerNorm.weight"] = \
            np.asarray(layers["out_ln"]["scale"], np.float32)[i]
        out[f"{pre}.qformer.layer.{i}.output.LayerNorm.bias"] = \
            np.asarray(layers["out_ln"]["bias"], np.float32)[i]

    out[f"{pre}.proj.0.weight"] = np.asarray(connector["proj_ln"]["scale"],
                                             np.float32)
    out[f"{pre}.proj.0.bias"] = np.asarray(connector["proj_ln"]["bias"],
                                           np.float32)
    out[f"{pre}.proj.1.weight"] = np.asarray(connector["proj"]["w"],
                                             np.float32).T
    out[f"{pre}.proj.1.bias"] = np.asarray(connector["proj"]["b"],
                                           np.float32)
    return out


def _qformer_from_ref(connector: Dict[str, Any],
                      sd: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """Build a new connector tree from reference-keyed arrays, using the
    existing tree for structure/dtype."""
    import jax
    pre = "perception.connector"
    # legacy-key rename (reference load_state_dict, modeling_desta25.py:
    # 1294-1310 renames ocar_* -> orca_*); qformer keys are stable.
    n_taps = int(np.asarray(connector["layer_prompts"]).shape[0])
    new = jax.tree.map(lambda x: x, connector)  # shallow copy of structure

    new["layer_prompts"] = jnp.stack([
        jnp.asarray(sd[f"{pre}.layer_prompts.{i}"][0]) for i in range(n_taps)
    ])
    new["layer_weights"] = jnp.asarray(sd[f"{pre}.layer_weights"])

    n = int(np.asarray(connector["qformer"]["layers"]["inter"]["w"]).shape[0])

    def attn_block(i, ref_block):
        return {
            "q": {"w": sd[f"{pre}.qformer.layer.{i}.{ref_block}.self.query.weight"].T,
                  "b": sd[f"{pre}.qformer.layer.{i}.{ref_block}.self.query.bias"]},
            "k": {"w": sd[f"{pre}.qformer.layer.{i}.{ref_block}.self.key.weight"].T,
                  "b": sd[f"{pre}.qformer.layer.{i}.{ref_block}.self.key.bias"]},
            "v": {"w": sd[f"{pre}.qformer.layer.{i}.{ref_block}.self.value.weight"].T,
                  "b": sd[f"{pre}.qformer.layer.{i}.{ref_block}.self.value.bias"]},
            "o": {"w": sd[f"{pre}.qformer.layer.{i}.{ref_block}.output.dense.weight"].T,
                  "b": sd[f"{pre}.qformer.layer.{i}.{ref_block}.output.dense.bias"]},
            "ln": {"scale": sd[f"{pre}.qformer.layer.{i}.{ref_block}.output.LayerNorm.weight"],
                   "bias": sd[f"{pre}.qformer.layer.{i}.{ref_block}.output.LayerNorm.bias"]},
        }

    per_layer = []
    for i in range(n):
        per_layer.append({
            "self": attn_block(i, "attention"),
            "cross": attn_block(i, "crossattention"),
            "inter": {"w": sd[f"{pre}.qformer.layer.{i}.intermediate.dense.weight"].T,
                      "b": sd[f"{pre}.qformer.layer.{i}.intermediate.dense.bias"]},
            "out": {"w": sd[f"{pre}.qformer.layer.{i}.output.dense.weight"].T,
                    "b": sd[f"{pre}.qformer.layer.{i}.output.dense.bias"]},
            "out_ln": {"scale": sd[f"{pre}.qformer.layer.{i}.output.LayerNorm.weight"],
                       "bias": sd[f"{pre}.qformer.layer.{i}.output.LayerNorm.bias"]},
        })
    from ..ops.core import stack_layers
    new["qformer"] = {"layers": jax.tree.map(jnp.asarray,
                                             stack_layers(per_layer))}
    new["proj_ln"] = {"scale": jnp.asarray(sd[f"{pre}.proj.0.weight"]),
                      "bias": jnp.asarray(sd[f"{pre}.proj.0.bias"])}
    new["proj"] = {"w": jnp.asarray(sd[f"{pre}.proj.1.weight"].T),
                   "b": jnp.asarray(sd[f"{pre}.proj.1.bias"])}
    return new


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def trainable_state_dict(trainable: Dict[str, Any],
                         config: DeSTA25Config) -> Dict[str, np.ndarray]:
    """Our trainable tree -> reference-named torch-layout arrays."""
    out: Dict[str, np.ndarray] = {}
    if config.connector_mode == "qformer_1":
        out.update(_qformer_to_ref(trainable["connector"]))
    elif config.connector_mode == "orca_hybrid":
        from .orca_io import orca_to_ref
        out.update(orca_to_ref(trainable, config))
    if "lora" in trainable:
        from .lora_io import lora_to_ref
        out.update(lora_to_ref(trainable["lora"], config))
    return out


def save_trainable_safetensors(trainable: Dict[str, Any],
                               config: DeSTA25Config, path: str):
    from safetensors.numpy import save_file
    sd = trainable_state_dict(trainable, config)
    save_file({k: np.ascontiguousarray(v) for k, v in sd.items()}, path)


def load_trainable_safetensors(params: Dict[str, Any],
                               config: DeSTA25Config,
                               path: str) -> Dict[str, Any]:
    from safetensors.numpy import load_file
    sd = load_file(path)
    # legacy-key rename (reference modeling_desta25.py:1294-1310)
    sd = {k.replace("ocar_", "orca_"): v for k, v in sd.items()}
    params = dict(params)
    if config.connector_mode == "qformer_1":
        params["connector"] = _qformer_from_ref(params["connector"], sd)
    elif config.connector_mode == "orca_hybrid":
        from .orca_io import orca_from_ref
        params = orca_from_ref(params, sd, config)
    if "lora" in params and any("lora_A" in k for k in sd):
        from .lora_io import lora_from_ref
        params["lora"] = lora_from_ref(params["lora"], sd)
    return params


def load_frozen_tower(tower: str, model_id: str, weights_root: str,
                      config: DeSTA25Config, dtype,
                      quant: Optional[str] = None) -> Optional[Dict]:
    """Load a frozen tower from ``weights_root/<model_id>/``.

    Prefers the staged native format written by the ``hf_convert`` CLI
    (``desta_native.safetensors`` / ``desta_native_int8.safetensors``);
    falls back to converting raw HF-layout ``*.safetensors`` shards in
    place.  All conversion work runs on the host CPU device, so the f32
    intermediates of an 8B conversion never take device memory.  The
    finished tree goes to the devices once: sharded by the tower's
    partition specs when a mesh is active, else onto the default device.
    """
    import jax

    from .flat_io import load_tree_safetensors
    from .hf_convert import (
        convert_llm_state,
        convert_whisper_state,
        load_safetensors_state,
    )
    path = os.path.join(weights_root, model_id)
    if not os.path.isdir(path):
        return None

    want_int8 = tower == "llm" and quant == "int8"
    native_q = os.path.join(path, "desta_native_int8.safetensors")
    native = os.path.join(path, "desta_native.safetensors")
    cpu = jax.devices("cpu")[0]

    if want_int8 and os.path.exists(native_q):
        tree = load_tree_safetensors(native_q)
    elif os.path.exists(native):
        tree = load_tree_safetensors(native)
        if not want_int8:
            tree = jax.tree.map(lambda a: a.astype(dtype), tree)
        if want_int8:
            from ..ops.quant import quantize_llm_params
            logger.warning("no pre-quantized %s; quantizing on host "
                           "(stage with --int8 to skip this)", native_q)
            with jax.default_device(cpu):
                tree = quantize_llm_params(tree)
    else:
        raw = [f for f in os.listdir(path) if f.endswith(".safetensors")]
        if not raw:
            return None
        sd = load_safetensors_state(path)
        with jax.default_device(cpu):
            if tower == "whisper":
                tree = convert_whisper_state(sd, config.encoder_config,
                                             dtype)
            else:
                tree = convert_llm_state(sd, config.llm_config, dtype)
                if want_int8:
                    from ..ops.quant import quantize_llm_params
                    tree = quantize_llm_params(tree)
    if tower == "whisper" and quant == "int8":
        from ..ops.quant import quantize_encoder_params
        with jax.default_device(cpu):
            tree = dict(tree)
            tree["encoder"] = quantize_encoder_params(tree["encoder"])
    from ..parallel.mesh import current_mesh
    if current_mesh() is not None:
        from ..parallel.sharding import (
            apply_sharding,
            llm_partition_specs,
            whisper_partition_specs,
        )
        specs = (llm_partition_specs if tower == "llm"
                 else whisper_partition_specs)(tree)
        return apply_sharding(tree, specs)
    return jax.device_put(jax.tree.map(jnp.asarray, tree), jax.devices()[0])
