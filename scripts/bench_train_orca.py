"""ORCA-hybrid flagship train step on one GPU.

Same geometry as the Q-Former flagship bench (b12, seq300, frozen bf16
tower, remat, adafactor) but with the ORCA hybrid connector + gated
cross-attention deep injection after every LLM layer — the per-layer
cross-attn activations ride the tower's backprop, changing the remat
economics.  Reports step time, samples/s, and the step's memory
analysis.

    python scripts/bench_train_orca.py [batch]
"""
import os
import sys
import time

import jax
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from desta25_audio_tpu.train.bench_utils import (  # noqa: E402
    build_flagship_train_setup,
    hbm_analysis,
)
from desta25_audio_tpu.utils.compilation_cache import (  # noqa: E402
    setup_compilation_cache,
)


def main():
    B = int(sys.argv[1]) if len(sys.argv) > 1 else 12
    setup_compilation_cache()
    print(f"batch {B} on {jax.devices()[0].device_kind}")

    t0 = time.time()
    cfg, step, trainable, frozen, opt_state, batch = \
        build_flagship_train_setup(batch_size=B, seq_len=300,
                                   connector_mode="orca_hybrid")
    jax.block_until_ready((trainable, frozen))
    print(f"setup {time.time()-t0:.1f}s")
    print("hbm:", hbm_analysis(step, trainable, frozen, opt_state, batch))
    t0 = time.time()
    trainable, opt_state, m = step(trainable, frozen, opt_state, batch)
    loss = float(m["lm_loss"])
    print(f"compile+step {time.time()-t0:.0f}s loss={loss:.3f} "
          f"(aux keys: {sorted(m)})")
    for i in range(2):
        trainable, opt_state, m = step(trainable, frozen, opt_state,
                                       batch)
        print(f"warm {i}: " + " ".join(
            f"{k}={float(v):.3f}" for k, v in sorted(m.items())
            if getattr(v, 'ndim', 1) == 0))
    best = None
    for _ in range(4):
        t0 = time.time()
        trainable, opt_state, m = jax.block_until_ready(
            step(trainable, frozen, opt_state, batch))
        lm = float(m["lm_loss"])
        dt = time.time() - t0
        print(f"timed: lm={lm:.3f} grad_norm={float(m['grad_norm']):.3f} "
              f"{dt*1e3:.0f} ms")
        best = dt if best is None else min(best, dt)
    assert np.isfinite(lm)
    print(f"ORCA train step: {best*1e3:.0f} ms -> "
          f"{B/best:.2f} samples/s")


if __name__ == "__main__":
    main()
