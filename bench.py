"""Benchmark harness — prints ONE JSON line.

Headline: audio-sec/s through the perception path (log-mel frontend ->
whisper-large-v3 encoder with layer taps -> 6-layer Q-Former connector),
bf16, batch 8, on one GPU.

Also reported in "detail": the int8-encoder perception rate, decode
tokens/s for the flagship Llama-3.1-8B with int8 weights at batch 8 and
32, p50 TTFT for a single-clip request (mel -> encoder -> connector ->
splice -> 8B prefill -> first token), engine-shaped serving ticks, the
flagship connector train step, and ORCA (Qwen3-4B) decode with deep
injection.  Every number names the platform, device kind, device count
and the card's power limit it was taken on.

Timing: work ends in ``jax.block_until_ready`` inside the timed region;
the first call of every program (compilation) is excluded.  Needs a GPU.

``vs_baseline`` is null: the reference publishes no throughput numbers
(SURVEY §6).
"""

import json
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from desta25_audio_tpu.utils.compilation_cache import setup_compilation_cache

BATCH = 8
ITERS = 10
CLIP_SECONDS = 30

_RESULT = {
    "metric": "audio-sec/s (log-mel + whisper-large-v3 encoder "
              "+ qformer-6L, bf16, batch 8)",
    "value": 0.0,
    "unit": "audio-sec/s",
    "vs_baseline": None,
    "detail": {},
}


def _timed(fn, *args):
    """Seconds for one call of fn, ending in block_until_ready."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return time.perf_counter() - t0, out


def _section(detail, errkey, fn, *args, **kwargs):
    """Run one bench section; a failure is recorded under ``errkey`` and
    fails the run after the JSON line is printed."""
    try:
        detail.update(fn(*args, **kwargs))
    except Exception as e:  # noqa: BLE001 - recorded, fails the run
        detail[errkey] = f"{type(e).__name__}: {e}"[:300]


def main():
    if jax.default_backend() != "gpu":
        print(f"no GPU: JAX's default backend is {jax.default_backend()}",
              file=sys.stderr)
        return 2
    setup_compilation_cache()
    dev = jax.devices()[0]
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    detail = _RESULT["detail"]
    detail.update({"platform": dev.platform, "device_kind": dev.device_kind,
                   "device_count": len(jax.devices()),
                   "nvidia_smi": gpu})
    t0 = time.perf_counter()
    _section(detail, "error", _headline_and_sections, detail)
    detail["elapsed_s"] = round(time.perf_counter() - t0, 1)
    print(json.dumps(_RESULT), flush=True)
    return 1 if any(k.endswith("error") for k in detail) else 0


def _headline_and_sections(detail):
    from desta25_audio_tpu.config import DeSTA25Config
    from desta25_audio_tpu.models import whisper as jw
    from desta25_audio_tpu.models.qformer import (
        init_qformer_connector,
        qformer_connector_apply,
    )
    from desta25_audio_tpu.audio.mel import log_mel

    cfg = DeSTA25Config(
        llm_model_id="DeSTA-ntu/Llama-3.1-8B-Instruct",
        encoder_model_id="openai/whisper-large-v3",
        connector_mode="qformer_1", qformer_num_hidden_layers=6,
        prompt_size=64, dtype="bfloat16")
    enc_cfg = cfg.encoder_config

    import sys

    from desta25_audio_tpu.utils.fast_init import random_tree_like

    key = jax.random.PRNGKey(0)
    # fast init: random magnitudes are all a perf benchmark needs
    t_init = time.time()
    enc_params = random_tree_like(
        key, lambda k: jw.init_whisper_encoder(k, enc_cfg,
                                               dtype=jnp.bfloat16))
    conn_params = random_tree_like(
        key, lambda k: init_qformer_connector(k, cfg, dtype=jnp.bfloat16))
    jax.block_until_ready((enc_params, conn_params))
    print(f"init done in {time.time()-t_init:.1f}s", file=sys.stderr)

    n_samples = CLIP_SECONDS * 16000

    def perception(ep, cp, audio):
        mel = log_mel(audio, enc_cfg.num_mel_bins).astype(jnp.bfloat16)
        _, taps = jw.whisper_encoder_apply(ep, mel, enc_cfg,
                                           cfg.target_layer_ids)
        feats = qformer_connector_apply(cp, taps, cfg)
        return jnp.sum(feats.astype(jnp.float32))

    # NB: params are explicit jit ARGUMENTS — closing over them would bake
    # 1.3 GB of weights into the HLO as constants and melt the compiler.
    def many(ep, cp, x0):
        def body(carry, i):
            y = perception(ep, cp, x0 + i.astype(jnp.float32) * 1e-6)
            return carry + y, None
        acc, _ = jax.lax.scan(body, jnp.float32(0.0), jnp.arange(ITERS))
        return acc

    f = jax.jit(many)
    x0 = jax.random.normal(jax.random.PRNGKey(1), (BATCH, n_samples),
                           jnp.float32) * 0.1
    t_c, _ = _timed(f, enc_params, conn_params, x0)  # compile + warm
    print(f"compile+first-run {t_c:.1f}s", file=sys.stderr)
    total, _ = _timed(f, enc_params, conn_params, x0)
    per_iter = total / ITERS
    _RESULT["value"] = round(BATCH * CLIP_SECONDS / per_iter, 1)
    detail.update({
        "ms_per_batch": round(per_iter * 1e3, 3),
        "iters": ITERS,
        "batch": BATCH,
    })

    def perception_int8():
        # encoder_quant="int8" (the "auto" inference default): W8A8
        # FFN and attention projections
        from desta25_audio_tpu.ops.quant import quantize_encoder_params
        enc_q = jax.jit(quantize_encoder_params)(enc_params)
        fq = jax.jit(many)
        _timed(fq, enc_q, conn_params, x0)
        t, _ = _timed(fq, enc_q, conn_params, x0)
        return {"perception_int8_audio_sec_s": round(
            BATCH * CLIP_SECONDS * ITERS / t, 1)}

    _section(detail, "perception_int8_error", perception_int8)
    _section(detail, "decode_error", bench_decode_and_ttft,
             enc_params, conn_params, cfg, x0[:1])

    # free the perception benchmark's params before the train bench
    # allocates its own flagship towers
    del enc_params, conn_params
    _section(detail, "train_error", bench_train)
    _section(detail, "orca_error", bench_orca_decode)
    return {}


def bench_decode_and_ttft(enc_params, conn_params, cfg, clip1):
    """Flagship decode tokens/s (Llama-3.1-8B, int8 weights) + TTFT."""
    import sys

    from desta25_audio_tpu.config import DeSTA25Config, llm_config_for
    from desta25_audio_tpu.models import llm as jllm
    from desta25_audio_tpu.models import whisper as jw
    from desta25_audio_tpu.models.qformer import (
        init_qformer_connector,
        qformer_connector_apply,
    )
    from desta25_audio_tpu.audio.mel import log_mel
    from desta25_audio_tpu.ops.quant import quantize_llm_params
    from desta25_audio_tpu.utils.fast_init import random_tree_like

    llm_cfg = llm_config_for("DeSTA-ntu/Llama-3.1-8B-Instruct")
    qshape = jax.eval_shape(
        lambda k: quantize_llm_params(
            jllm.init_llm(k, llm_cfg, dtype=jnp.bfloat16)),
        jax.random.PRNGKey(0))
    lp = random_tree_like(jax.random.PRNGKey(2), lambda k: qshape,
                          scale=0.02)
    cfg8 = DeSTA25Config(
        llm_model_id="DeSTA-ntu/Llama-3.1-8B-Instruct",
        encoder_model_id=cfg.encoder_model_id,
        connector_mode="qformer_1", qformer_num_hidden_layers=6,
        prompt_size=cfg.prompt_size, dtype="bfloat16")
    conn8 = random_tree_like(
        jax.random.PRNGKey(3),
        lambda k: init_qformer_connector(k, cfg8, dtype=jnp.bfloat16))
    jax.block_until_ready((lp, conn8))
    print("llm init done", file=sys.stderr)

    enc_cfg = cfg.encoder_config
    CTX, STEPS = 192, 64

    def make_decode(B):
        """Prefill OUTSIDE the timed region (its own jit); the timed
        program is the pure decode scan — sustained decode tok/s, not
        prefill-amortized."""
        Tmax = CTX + STEPS
        mask = jnp.ones((B, Tmax), jnp.int32)

        def prefill(params):
            cache = jllm.init_kv_cache(llm_cfg, B, Tmax,
                                       dtype=jnp.bfloat16)
            ids = jnp.ones((B, CTX), jnp.int32)
            logits, cache, _ = jllm.llm_apply(
                params, llm_cfg, input_ids=ids, attention_mask=mask,
                cache=cache, cache_index=0)
            return jnp.argmax(logits[:, -1], -1).astype(jnp.int32), cache

        def decode_scan(params, tok, cache):
            def body(carry, t):
                tok, cache = carry
                lg, cache, _ = jllm.llm_apply(
                    params, llm_cfg, input_ids=tok[:, None],
                    attention_mask=mask, positions=(CTX + t)[None, None]
                    + jnp.zeros((B, 1), jnp.int32),
                    cache=cache, cache_index=CTX + t)
                nxt = jnp.argmax(lg[:, -1], -1).astype(jnp.int32)
                return (nxt, cache), None

            (tok, cache), _ = jax.lax.scan(body, (tok, cache),
                                           jnp.arange(STEPS))
            # cache is returned (device-resident, never fetched) so the
            # donated input buffer is actually usable for aliasing
            return jnp.sum(tok), cache

        # donate the cache (it is re-made by prefill per timing rep) so
        # the cache writes stay in place
        return (jax.jit(prefill),
                jax.jit(decode_scan, donate_argnums=(2,)))

    decode_results = {}
    for B in (8, 32):
        pf, dec = make_decode(B)
        t0 = time.time()
        tok, cache = jax.block_until_ready(pf(lp))
        jax.block_until_ready(dec(lp, tok, cache))
        print(f"decode b{B} compile {time.time()-t0:.1f}s",
              file=sys.stderr)
        best = None
        for _ in range(3):
            tok, cache = jax.block_until_ready(pf(lp))
            dt, _ = _timed(dec, lp, tok, cache)
            best = dt if best is None else min(best, dt)
        decode_results[B] = B * STEPS / max(best, 1e-9)
    decode_tok_s = decode_results[8]

    # --- TTFT: single clip, full pipeline to first token ---------------
    T_CTX = 128
    K = cfg.prompt_size

    def ttft(enc_p, conn_p, llm_p, audio):
        mel = log_mel(audio, enc_cfg.num_mel_bins).astype(jnp.bfloat16)
        _, taps = jw.whisper_encoder_apply(enc_p, mel, enc_cfg,
                                           cfg8.target_layer_ids)
        # bf16 connector (the deployed generate() path)
        feats = qformer_connector_apply(conn_p, taps, cfg8)
        ids = jnp.ones((1, T_CTX), jnp.int32)
        embeds = jllm.embed_tokens(llm_p, ids)
        embeds = jax.lax.dynamic_update_slice(
            embeds, feats.astype(embeds.dtype), (0, 4, 0))
        cache = jllm.init_kv_cache(llm_cfg, 1, T_CTX + 8,
                                   dtype=jnp.bfloat16)
        mask = jnp.ones((1, T_CTX + 8), jnp.int32)
        # last-token-only head: TTFT needs one next-token distribution,
        # not [T, 128k] logits
        _, _, hidden = jllm.llm_apply(
            llm_p, llm_cfg, inputs_embeds=embeds, attention_mask=mask,
            cache=cache, cache_index=0, skip_head=True,
            return_hidden=True)
        from desta25_audio_tpu.models.llm import _head_logits
        return jnp.argmax(_head_logits(llm_p, llm_cfg, hidden[:, -1:]
                                       )[0, -1])

    # Deployment-default encoder (encoder_quant="auto" -> int8 at the
    # inference entrypoints).  The headline TTFT measures this default;
    # bf16 is the opt-out detail.
    from desta25_audio_tpu.ops.quant import quantize_encoder_params
    enc_q = jax.jit(quantize_encoder_params)(enc_params)
    g = jax.jit(ttft)

    def ttft_p50(ep):
        _timed(g, ep, conn8, lp, clip1)
        samples = sorted(_timed(g, ep, conn8, lp, clip1)[0]
                         for _ in range(7))
        return samples[len(samples) // 2]

    out = {
        "decode_tok_s_llama8b_int8_b8": round(decode_results[8], 1),
        "decode_tok_s_llama8b_int8_b32": round(decode_results[32],
                                                        1),
        "ttft_p50_ms_single_clip_llama8b_int8": round(ttft_p50(enc_q) * 1e3,
                                                      2),
    }
    # bf16-encoder reference point (encoder_quant="none" opt-out)
    out["ttft_bf16enc_p50_ms"] = round(ttft_p50(enc_params) * 1e3, 2)
    del enc_q
    _section(out, "serving_error", bench_serving, lp, llm_cfg)
    return out


def bench_serving(lp, llm_cfg):
    """Engine-shaped serving throughput: per-row cache indices, K=8
    decode steps per tick, mixed greedy/sampled slots — mirrors
    serve/engine._decode_steps.  The MEDIAN of 9 ticks after 5 warm-up
    ticks is reported."""
    import sys

    from desta25_audio_tpu.generate.decode import sample_token_dynamic
    from desta25_audio_tpu.models import llm as jllm

    K, T_MAX = 8, 384
    results = {}
    for B in (8, 16, 32):
        cache = jllm.init_kv_cache(llm_cfg, B, T_MAX, dtype=jnp.bfloat16)
        ci0 = (64 + 16 * jnp.arange(B, dtype=jnp.int32)) % 256
        mask0 = (jnp.arange(T_MAX)[None, :] < ci0[:, None]).astype(
            jnp.int32)
        toks0 = jnp.ones((B,), jnp.int32)
        temp = jnp.full((B,), 0.7, jnp.float32)
        top_p = jnp.full((B,), 0.9, jnp.float32)
        do_sample = (jnp.arange(B) % 2 == 0)
        t_idx = jnp.arange(T_MAX)

        def tick(params, cache, toks, ci, mask, key):
            def body(carry, s):
                cur, cache, ci, mask = carry
                step_mask = mask | (t_idx[None, :] == ci[:, None]
                                    ).astype(jnp.int32)
                lg, cache, _ = jllm.llm_apply(
                    params, llm_cfg, input_ids=cur[:, None],
                    attention_mask=step_mask, positions=ci[:, None],
                    cache=cache, cache_index=ci)
                nxt = sample_token_dynamic(
                    lg[:, -1].astype(jnp.float32),
                    jax.random.fold_in(key, s), temp, top_p, do_sample)
                return (nxt, cache, ci + 1, step_mask), nxt

            (cur, cache, ci, mask), outs = jax.lax.scan(
                body, (toks, cache, ci, mask), jnp.arange(K))
            return cache, jnp.sum(outs)

        f = jax.jit(tick, donate_argnums=(1,))
        key = jax.random.PRNGKey(0)
        t0 = time.time()
        cache, s = jax.block_until_ready(f(lp, cache, toks0, ci0, mask0,
                                           key))
        print(f"serving b{B} compile {time.time()-t0:.1f}s",
              file=sys.stderr)
        for _ in range(5):
            cache, s = jax.block_until_ready(f(lp, cache, toks0, ci0,
                                               mask0, key))
        samples = []
        for _ in range(9):
            dt, (cache, s) = _timed(f, lp, cache, toks0, ci0, mask0, key)
            samples.append(dt)
        samples.sort()
        med = samples[len(samples) // 2]
        results[f"serving_tok_s_{B}slots"] = round(B * K / med, 1)
        results[f"serving_tick_ms_{B}slots_p50"] = round(med * 1e3, 2)
    return results


def bench_orca_decode():
    """ORCA flagship decode (Qwen3-4B int8 + int8 gated cross-attention,
    Ta=440 audio tokens, b8) with the injection applied after every
    decoder layer through ``extra_layer_fn``, then the engine's own
    decode-tick program at the serving geometry."""
    import sys

    from desta25_audio_tpu.config import llm_config_for
    from desta25_audio_tpu.models import llm as jllm
    from desta25_audio_tpu.models.orca import gated_cross_attention_apply
    from desta25_audio_tpu.ops.quant import (
        quantize_llm_params,
        quantize_orca_cross_attns,
    )
    from desta25_audio_tpu.utils.fast_init import random_tree_like

    B, CTX, STEPS, TA = 8, 192, 32, 440
    llm_cfg = llm_config_for("Qwen/Qwen3-4B")
    L, D, H = (llm_cfg.num_hidden_layers, llm_cfg.hidden_size,
               llm_cfg.num_attention_heads)
    qshape = jax.eval_shape(
        lambda k: quantize_llm_params(
            jllm.init_llm(k, llm_cfg, dtype=jnp.bfloat16)),
        jax.random.PRNGKey(0))
    lp = random_tree_like(jax.random.PRNGKey(2), lambda k: qshape,
                          scale=0.02)

    def build_xattn(key):
        from desta25_audio_tpu.ops.core import (
            init_layer_norm,
            init_linear,
            stack_layers,
        )
        layers = []
        for _ in range(L):
            key, kq, kk, kv, ko, kg1 = jax.random.split(key, 6)
            layers.append({
                "q": init_linear(kq, D, D), "k": init_linear(kk, D, D),
                "v": init_linear(kv, D, D), "o": init_linear(ko, D, D),
                "gate1": init_linear(kg1, D, D // 4),
                "gate2": {"w": jnp.zeros((D // 4, 1), jnp.float32),
                          "b": jnp.zeros((1,), jnp.float32)},
                "ln": init_layer_norm(D),
            })
        return quantize_orca_cross_attns({"layers": stack_layers(layers)})

    xshape = jax.eval_shape(build_xattn, jax.random.PRNGKey(0))
    xp = random_tree_like(jax.random.PRNGKey(3), lambda k: xshape,
                          scale=0.02)
    ka = (jax.random.normal(jax.random.PRNGKey(4), (L, B, TA, D),
                            jnp.bfloat16) * 0.1)
    va = (jax.random.normal(jax.random.PRNGKey(5), (L, B, TA, D),
                            jnp.bfloat16) * 0.1)
    jax.block_until_ready((lp, xp, ka, va))
    print("orca init done", file=sys.stderr)

    Tmax = CTX + STEPS
    mask = jnp.ones((B, Tmax), jnp.int32)

    def prefill(params):
        cache = jllm.init_kv_cache(llm_cfg, B, Tmax, dtype=jnp.bfloat16)
        ids = jnp.ones((B, CTX), jnp.int32)
        logits, cache, _ = jllm.llm_apply(
            params, llm_cfg, input_ids=ids, attention_mask=mask,
            cache=cache, cache_index=0)
        return jnp.argmax(logits[:, -1], -1).astype(jnp.int32), cache

    def decode_scan(params, xattn, inj_k, inj_v, tok, cache):
        def extra(idx, h):
            lpz = jax.tree.map(lambda a: a[idx], xattn["layers"])
            return gated_cross_attention_apply(
                lpz, h, None, H, cached_kv=(inj_k[idx], inj_v[idx]))

        def body(carry, t):
            tok, cache = carry
            lg, cache, _ = jllm.llm_apply(
                params, llm_cfg, input_ids=tok[:, None],
                attention_mask=mask,
                positions=(CTX + t)[None, None]
                + jnp.zeros((B, 1), jnp.int32),
                cache=cache, cache_index=CTX + t, extra_layer_fn=extra)
            nxt = jnp.argmax(lg[:, -1], -1).astype(jnp.int32)
            return (nxt, cache), None

        (tok, cache), _ = jax.lax.scan(body, (tok, cache),
                                       jnp.arange(STEPS))
        return jnp.sum(tok), cache

    pf = jax.jit(prefill)
    dec = jax.jit(decode_scan, donate_argnums=(5,))
    t0 = time.time()
    tok, cache = jax.block_until_ready(pf(lp))
    jax.block_until_ready(dec(lp, xp, ka, va, tok, cache))
    print(f"orca compile {time.time()-t0:.1f}s", file=sys.stderr)
    best = None
    for _ in range(3):
        tok, cache = jax.block_until_ready(pf(lp))
        dt, _ = _timed(dec, lp, xp, ka, va, tok, cache)
        best = dt if best is None else min(best, dt)
    out = {"orca_decode_tok_s_b8": round(B * STEPS / best, 1)}
    del tok, cache
    out.update(_orca_serving_tick(lp, llm_cfg, xp, ka, va))
    return out


def _orca_serving_tick(lp, llm_cfg, xp, ka, va):
    """ORCA serving tick = the engine's `_decode_steps` program, jitted
    off a minimal engine stub at the serving-load geometry (8 slots,
    t_max=304 = 256 ctx + 48 new, K=8 steps/tick, the 440 injected
    audio tokens of the decode section, CharTokenizer terminators
    {1, 4}).  The per-tick host loop
    is NOT included (dispatch + fetch only)."""
    import sys

    from desta25_audio_tpu.models import llm as jllm
    from desta25_audio_tpu.serve.engine import ContinuousBatchingEngine

    B, K, Tmax = 8, 8, 304
    eng = ContinuousBatchingEngine.__new__(ContinuousBatchingEngine)
    eng.cfg = llm_cfg
    eng._eos = {1, 4}
    eng._inject_len = ka.shape[2]
    eng.t_max = Tmax
    eng.steps_per_tick = K
    eng.model = type("_M", (), {"config": type("_C", (), {
        "lora_scale": 1.0})()})()
    tick = jax.jit(eng._decode_steps)

    ci0 = np.asarray((64 + 16 * np.arange(B)) % 192, np.int32)
    mask0 = (np.arange(Tmax)[None, :] < ci0[:, None]).astype(np.int32)
    temp = jnp.full((B,), 0.7, jnp.float32)
    top_p = jnp.full((B,), 0.9, jnp.float32)
    do_sample = jnp.asarray(np.arange(B) % 2 == 0)
    on = jnp.ones((B,), jnp.float32)
    toks0 = jnp.ones((B,), jnp.int32)
    wp = jnp.asarray(ci0)
    mask_d = jnp.asarray(mask0)
    key = jax.random.PRNGKey(0)
    cache = jllm.init_kv_cache(llm_cfg, B, Tmax, dtype=jnp.bfloat16)

    def run():
        return tick(lp, xp, cache, toks0, wp, wp, mask_d, ka, va, on,
                    temp, top_p, do_sample, key)

    t0 = time.time()
    jax.block_until_ready(run())
    print(f"orca serving compile {time.time()-t0:.1f}s", file=sys.stderr)
    for _ in range(4):
        jax.block_until_ready(run())
    samples = []
    for _ in range(9):
        samples.append(_timed(run)[0])
    samples.sort()
    med = samples[len(samples) // 2]
    return {"orca_serving_tok_s_8slots": round(B * K / med, 1),
            "orca_serving_tick_ms_8slots_p50": round(med * 1e3, 2)}


def bench_train():
    """Flagship training step on one card: whisper-large-v3 bf16 + frozen
    Llama-3.1-8B bf16 + 6L Q-Former (f32, adafactor), remat, reference
    batch geometry (per-device batch 12, seq 300)."""
    import sys
    import time as _t

    from desta25_audio_tpu.train.bench_utils import (
        build_flagship_train_setup,
        hbm_analysis,
    )

    B = 12
    t0 = _t.time()
    cfg, step, trainable, frozen, opt_state, batch = \
        build_flagship_train_setup(batch_size=B, seq_len=300)
    jax.block_until_ready((trainable, frozen))
    print(f"train setup {_t.time()-t0:.1f}s", file=sys.stderr)

    mem = hbm_analysis(step, trainable, frozen, opt_state, batch)
    t0 = _t.time()
    trainable, opt_state, metrics = step(trainable, frozen, opt_state,
                                         batch)
    loss0 = float(metrics["lm_loss"])
    print(f"train compile+step {_t.time()-t0:.1f}s loss={loss0:.3f}",
          file=sys.stderr)
    # warm (donated buffers force fresh step calls)
    for _ in range(2):
        trainable, opt_state, metrics = step(trainable, frozen, opt_state,
                                             batch)
        float(metrics["lm_loss"])
    N = 4
    t0 = _t.time()
    for _ in range(N):
        trainable, opt_state, metrics = step(trainable, frozen, opt_state,
                                             batch)
    lm = float(jax.block_until_ready(metrics)["lm_loss"])
    step_s = (_t.time() - t0) / N
    assert np.isfinite(lm), lm
    return {
        "train_samples_per_s_llama8b_frozen": round(B / step_s, 2),
        "train_step_ms_b12_seq300": round(step_s * 1e3, 1),
        "train_hbm": mem,
    }


if __name__ == "__main__":
    sys.exit(main())
