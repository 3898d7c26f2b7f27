"""Tensor-parallel decode through GSPMD: the tower sharded over a "model"
mesh axis (parallel/sharding.py specs), XLA inserting the all-reduces,
against the same decode on one device.  Runs on the virtual CPU devices
of tests/conftest.py."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from desta25_audio_tpu.models import llm as jllm
from desta25_audio_tpu.parallel.mesh import make_mesh, use_mesh
from desta25_audio_tpu.parallel.sharding import (
    apply_sharding,
    llm_partition_specs,
)

from test_xla_decode import nano_cfg, rel_err, towers


def _mesh(n_data, n_model):
    n = n_data * n_model
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} devices")
    return make_mesh(n_data=n_data, n_model=n_model,
                     devices=jax.devices()[:n])


def _decode(p, cfg, ids, S, n_steps):
    """Prefill ``ids`` then greedy-decode n_steps; returns (step logits
    [n, B, V], tokens [n, B], final cache)."""
    B, T = ids.shape
    cache = jllm.init_kv_cache(cfg, B, S, dtype=jnp.bfloat16)
    mask = jnp.ones((B, S), jnp.int32)
    lg, cache, _ = jllm.llm_apply(p, cfg, input_ids=ids,
                                  attention_mask=mask, cache=cache,
                                  cache_index=0)
    tok = jnp.argmax(lg[:, -1], -1).astype(jnp.int32)
    outs, toks = [], []
    for t in range(n_steps):
        lg, cache, _ = jllm.llm_apply(
            p, cfg, input_ids=tok[:, None], attention_mask=mask,
            positions=jnp.full((B, 1), T + t, jnp.int32), cache=cache,
            cache_index=T + t)
        outs.append(np.asarray(lg[:, -1], np.float32))
        tok = jnp.argmax(lg[:, -1], -1).astype(jnp.int32)
        toks.append(np.asarray(tok))
    return np.stack(outs), np.stack(toks), cache


@pytest.mark.parametrize("tower", ["bf16", "int8"])
@pytest.mark.parametrize("n_data,n_model", [(1, 2), (2, 2), (1, 4)])
def test_tp_decode_matches_one_device(n_data, n_model, tower):
    cfg = nano_cfg(gqa=False)  # 4 kv heads: splits 2 and 4 ways
    _, p = towers(cfg, seed=3)[tower]
    B, S = 4, 32
    ids = jnp.asarray(np.random.default_rng(0).integers(2, 500, (B, 9)),
                      jnp.int32)
    ref, ref_tok, ref_cache = _decode(p, cfg, ids, S, 3)
    with use_mesh(_mesh(n_data, n_model)):
        sharded = apply_sharding(p, llm_partition_specs(p))
        got, got_tok, got_cache = _decode(sharded, cfg, ids, S, 3)
    # the all-reduce sums partial products in another order
    assert rel_err(got, ref) < 2e-2
    np.testing.assert_array_equal(got_tok, ref_tok)
    np.testing.assert_allclose(np.asarray(got_cache.k, np.float32),
                               np.asarray(ref_cache.k, np.float32),
                               rtol=2e-2, atol=2e-2)


def test_tp_verify_and_per_row_offsets():
    """Serving shapes under TP: a T=Kd verify at per-row cache offsets
    matches the one-device call."""
    cfg = nano_cfg()
    _, p = towers(cfg, seed=4)["int8"]
    B, S, Kd = 2, 48, 3
    rng = np.random.default_rng(1)
    warm = jnp.asarray(rng.integers(2, 500, (B, 24)), jnp.int32)
    toks = jnp.asarray(rng.integers(2, 500, (B, Kd)), jnp.int32)
    ci = jnp.asarray([13, 21], jnp.int32)
    mask = jnp.ones((B, S), jnp.int32)

    def run(params):
        cache = jllm.init_kv_cache(cfg, B, S, dtype=jnp.bfloat16)
        _, cache, _ = jllm.llm_apply(params, cfg, input_ids=warm,
                                     attention_mask=mask, cache=cache,
                                     cache_index=0)
        lg, cache, _ = jllm.llm_apply(
            params, cfg, input_ids=toks, attention_mask=mask,
            positions=ci[:, None] + jnp.arange(Kd)[None, :], cache=cache,
            cache_index=ci)
        return np.asarray(lg, np.float32), np.asarray(cache.k, np.float32)

    ref, ref_k = run(p)
    with use_mesh(_mesh(1, 2)):
        got, got_k = run(apply_sharding(p, llm_partition_specs(p)))
    assert rel_err(got, ref) < 2e-2
    np.testing.assert_allclose(got_k, ref_k, rtol=2e-2, atol=2e-2)


def test_tp_spec_generate_trajectory():
    """Speculative greedy decode with the tower sharded over "model"
    emits exactly the one-device plain greedy trajectory."""
    from desta25_audio_tpu.generate.decode import llm_generate
    from desta25_audio_tpu.generate.speculative import llm_generate_spec

    cfg = nano_cfg()
    _, p = towers(cfg, seed=5)["int8"]
    B, T, MAX_NEW, Kd = 2, 12, 8, 3
    ids = jnp.asarray(np.random.default_rng(21).integers(2, 500, (B, T)),
                      jnp.int32)
    amask = jnp.ones((B, T), jnp.int32)
    ref, ref_n = llm_generate(
        p, cfg, p["embed"][ids], amask, jax.random.PRNGKey(0),
        max_new_tokens=MAX_NEW, do_sample=False, eos_ids=(), pad_id=0)
    with use_mesh(_mesh(1, 2)):
        sharded = apply_sharding(p, llm_partition_specs(p))
        got, got_n = llm_generate_spec(
            sharded, cfg, sharded["embed"][ids], amask,
            max_new_tokens=MAX_NEW, eos_ids=(), pad_id=0,
            speculative_k=Kd, prompt_ids=ids,
            prompt_lens=jnp.full((B,), T, jnp.int32))
    np.testing.assert_array_equal(np.asarray(got_n), np.asarray(ref_n))
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def test_tp_orca_injection_decode():
    """ORCA deep injection under TP: replicated injection weights after
    the sharded tower's all-reduce match the one-device decode."""
    from test_orca_decode import setup_orca, xla_inject_fn

    cfg = nano_cfg()
    B, T_ctx, S = 2, 8, 32
    rng = np.random.default_rng(11)
    _, qparams, xattn, (inj_k, inj_v) = setup_orca(cfg, B, 12, seed=2)
    fn = xla_inject_fn(xattn, inj_k, inj_v, cfg.num_attention_heads,
                       jnp.asarray([1.0, 0.0], jnp.float32))
    ids = jnp.asarray(rng.integers(2, 500, size=(B, T_ctx)), jnp.int32)
    tok = jnp.asarray(rng.integers(2, 500, size=(B, 1)), jnp.int32)
    mask = jnp.ones((B, S), jnp.int32)

    def run(params):
        cache = jllm.init_kv_cache(cfg, B, S, dtype=jnp.bfloat16)
        _, cache, _ = jllm.llm_apply(params, cfg, input_ids=ids,
                                     attention_mask=mask, cache=cache,
                                     cache_index=0, extra_layer_fn=fn)
        lg, _, _ = jllm.llm_apply(
            params, cfg, input_ids=tok, attention_mask=mask,
            positions=jnp.full((B, 1), T_ctx, jnp.int32), cache=cache,
            cache_index=T_ctx, extra_layer_fn=fn)
        return np.asarray(lg[:, 0], np.float32)

    ref = run(qparams)
    with use_mesh(_mesh(1, 2)):
        got = run(apply_sharding(qparams, llm_partition_specs(qparams)))
    assert rel_err(got, ref) < 2e-2
