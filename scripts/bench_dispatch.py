"""Time the choices the model's dispatch rules make, on the GPU.

    python scripts/bench_dispatch.py [--out chiprun_out/dispatch.json]

1. Attention: ``jax.nn.dot_product_attention`` with implementation="cudnn"
   against "xla" at the whisper-large-v3 encoder (B=1 and 8, H=20,
   T=1500, Dh=64), the Q-Former cross-attention (64 queries over 1500
   frames) and Llama-3.1-8B prefill (causal, GQA 32/8, left padding).
2. int8 prefill matmul: W8A8 against dequant-then-dot at M=1536,
   K=N=4096 (``ops.quant._qmm_dispatch``).
3. One Llama-3.1-8B decode step (B=8, 512-token cache) with the int8
   tower: step time, XLA's bytes-accessed estimate against the weight
   bytes, and whether the optimized HLO converts int8 weights to bf16
   outside the matmul (a bf16 copy of the weights written every step).

Times are medians of block_until_ready-timed calls after a warm-up
call.  Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from desta25_audio_tpu.utils.compilation_cache import (  # noqa: E402
    setup_compilation_cache,
)


def timeit(fn, *args, iters=20):
    import jax
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def bench_attention(out):
    import jax
    import jax.numpy as jnp
    shapes = [
        ("encoder-b1", 1, 1500, 1500, 20, 20, 64, False, False),
        ("encoder-b8", 8, 1500, 1500, 20, 20, 64, False, False),
        ("qformer-cross", 32, 64, 1500, 20, 20, 64, False, False),
        ("llm-prefill", 4, 512, 512, 32, 8, 128, True, True),
    ]
    key = jax.random.PRNGKey(0)
    for name, B, Tq, Tk, H, Hkv, D, causal, padded in shapes:
        kq, kk, kv, key = jax.random.split(key, 4)
        q = jax.random.normal(kq, (B, Tq, H, D), jnp.bfloat16)
        k = jax.random.normal(kk, (B, Tk, Hkv, D), jnp.bfloat16)
        v = jax.random.normal(kv, (B, Tk, Hkv, D), jnp.bfloat16)
        mask = None
        if padded:
            lens = Tk - (jnp.arange(B) * Tk) // (2 * B)
            mask = jnp.broadcast_to(
                (jnp.arange(Tk)[None, :] >= (Tk - lens)[:, None])
                [:, None, None, :], (B, 1, Tq, Tk))
        row = {}
        for impl in ("cudnn", "xla"):
            f = jax.jit(lambda q, k, v, impl=impl: jax.nn.dot_product_attention(
                q, k, v, mask=mask, is_causal=causal, implementation=impl))
            row[impl] = timeit(f, q, k, v) * 1e3
        print(f"attention {name}: cudnn {row['cudnn']:.3f} ms, "
              f"xla {row['xla']:.3f} ms", flush=True)
        out["attention_ms"][name] = row


def bench_w8a8(out):
    import jax
    import jax.numpy as jnp

    from desta25_audio_tpu.ops.quant import _qmm_dispatch, quantize_weight
    M, K, N = 1536, 4096, 4096
    leaf = quantize_weight(jax.random.normal(jax.random.PRNGKey(1),
                                             (K, N)) * 0.02)
    x = jax.random.normal(jax.random.PRNGKey(2), (M, K), jnp.bfloat16)
    row = {}
    for name, w8a8 in (("w8a8", True), ("dequant", False)):
        f = jax.jit(lambda x, q, s, w8a8=w8a8: _qmm_dispatch(x, q, s, w8a8))
        row[name] = timeit(f, x, leaf["q"], leaf["s"]) * 1e3
    print(f"int8 prefill matmul M={M} K={K} N={N}: w8a8 {row['w8a8']:.3f} "
          f"ms, dequant-dot {row['dequant']:.3f} ms", flush=True)
    out["prefill_matmul_ms"] = row


def _hlo_convert_report(text, min_elems=1 << 20):
    """Scan the optimized HLO's computations.  Returns (fusions that turn
    an s8 operand into a bf16 array of at least ``min_elems`` elements
    with no matmul inside — a dequantized weight copy written to memory
    —, number of matmul fusions that read s8 directly)."""
    standalone, gemm_s8 = [], 0
    for block in text.split("\n\n"):
        header = block.split("\n", 1)[0]
        has_dot = " dot(" in block
        if has_dot and "s8[" in header:
            gemm_s8 += 1
        if has_dot or "s8[" not in header or "fused" not in header:
            continue
        for shape in re.findall(r"bf16\[([\d,]+)\]\{?[^\n]*convert\(",
                                block):
            if np.prod([int(x) for x in shape.split(",")]) >= min_elems:
                standalone.append((header.split()[0], shape))
                break
    return standalone, gemm_s8


def bench_decode(out, out_path):
    import jax
    import jax.numpy as jnp

    from desta25_audio_tpu.config import llm_config_for
    from desta25_audio_tpu.models import llm as jllm
    from desta25_audio_tpu.ops.quant import quantize_llm_params
    from desta25_audio_tpu.utils.fast_init import random_tree_like

    cfg = llm_config_for("DeSTA-ntu/Llama-3.1-8B-Instruct")
    B, S = 8, 512
    key = jax.random.PRNGKey(3)
    for tower in ("int8",):
        def init(k, tower=tower):
            p = jllm.init_llm(k, cfg, jnp.bfloat16)
            return quantize_llm_params(p) if tower == "int8" else p
        params = random_tree_like(key, init, scale=0.02)
        wbytes = sum(x.size * x.dtype.itemsize
                     for x in jax.tree.leaves(params))
        cache = jllm.init_kv_cache(cfg, B, S)
        mask = jnp.ones((B, S), jnp.int32)

        @jax.jit
        def step(p, cache, tok, ci):
            lg, cache, _ = jllm.llm_apply(
                p, cfg, input_ids=tok[:, None], attention_mask=mask,
                positions=jnp.full((B, 1), ci), cache=cache,
                cache_index=jnp.full((B,), ci, jnp.int32))
            return jnp.argmax(lg[:, -1], -1).astype(jnp.int32), cache

        tok = jnp.zeros((B,), jnp.int32)
        ci = jnp.asarray(S // 2, jnp.int32)
        compiled = step.lower(params, cache, tok, ci).compile()
        ca = compiled.cost_analysis()
        ca = ca[0] if isinstance(ca, (list, tuple)) else ca
        xla_bytes = float(ca.get("bytes accessed", float("nan")))
        hlo = compiled.as_text()
        standalone, gemm_s8 = _hlo_convert_report(hlo)
        with open(os.path.join(os.path.dirname(out_path) or ".",
                               f"decode_{tower}_hlo.txt"), "w") as f:
            f.write(hlo)
        t = timeit(lambda p, c, t_, i: compiled(p, c, t_, i), params, cache,
                   tok, ci)
        row = {"step_ms": t * 1e3, "weight_gb": wbytes / 1e9,
               "xla_bytes_accessed_gb": xla_bytes / 1e9,
               "weight_gb_per_s": wbytes / t / 1e9,
               "standalone_s8_to_bf16_fusions": len(standalone),
               "matmul_fusions_reading_s8": gemm_s8,
               "examples": [f"{n}: bf16[{shape}]"
                            for n, shape in standalone[:3]]}
        print(f"decode step 8B {tower} B={B} S={S}: {row['step_ms']:.3f} "
              f"ms, weights {row['weight_gb']:.2f} GB -> "
              f"{row['weight_gb_per_s']:.0f} GB/s; XLA bytes accessed "
              f"{row['xla_bytes_accessed_gb']:.2f} GB; s8->bf16 converts "
              f"outside a matmul: {len(standalone)}; matmul fusions "
              f"reading s8: {gemm_s8}", flush=True)
        if standalone:
            print("   e.g.", row["examples"])
        out["decode_step"][tower] = row
        del params, cache, compiled


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="chiprun_out/dispatch.json")
    args = ap.parse_args()
    import jax
    if jax.default_backend() != "gpu":
        print("no GPU", file=sys.stderr)
        return 2
    setup_compilation_cache()
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(f"gpu: {gpu}; {jax.devices()[0].device_kind}", flush=True)
    out = {"gpu": gpu, "attention_ms": {}, "decode_step": {}}
    bench_attention(out)
    bench_w8a8(out)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    bench_decode(out, args.out)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
