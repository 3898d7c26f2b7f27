"""chip_smoke.py's phases, rehearsed on the CPU at nano sizes: the same
control flow, checks and meshes the GPU run takes (the script itself
refuses to run without a GPU)."""

import os
import sys

import pytest

import jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402


def _nano_config(mode):
    from desta25_audio_tpu.config import DeSTA25Config
    orca = mode == "orca_hybrid"
    return DeSTA25Config(
        llm_model_id="test/qwen3-nano" if orca else "test/llama-nano",
        encoder_model_id="test/whisper-nano", connector_mode=mode,
        qformer_num_hidden_layers=2, prompt_size=8, dtype="bfloat16",
        orca_global_num_tokens=4, orca_local_downsample=4,
        orca_local_kernel_size=5, orca_xattn_dtype="bfloat16",
        placeholder_token=("<|video_pad|>" if orca
                           else "<|reserved_special_token_87|>"))


TINY = chip_smoke.Sizes(
    config=_nano_config,
    attn=(("self", 2, 40, 40, 4, 4, 16, False, False),
          ("cross", 2, 8, 60, 4, 4, 16, False, False),
          ("prefill", 2, 32, 32, 4, 2, 16, True, True)),
    qmm_k=256, qmm_n=128, qmm_decode_rows=8, qmm_prefill_rows=256,
    max_new=5, max_ctx=128, train_batch=2, train_seq=48, train_steps=2,
    tp_prompt=12, tp_new=5)


@pytest.fixture(scope="module")
def stats():
    return chip_smoke.CompileStats()


def test_smoke_one_card_phases(stats):
    assert chip_smoke.run_one_card(TINY, stats)


def test_smoke_four_card_phases(stats):
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    assert chip_smoke.run_four_cards(TINY, stats, jax.devices())


def test_smoke_refuses_without_gpu(capsys):
    """No GPU: non-zero exit and no result line."""
    assert chip_smoke.main([]) == 2
    out = capsys.readouterr()
    assert '"ok"' not in out.out and "no GPU" in out.err
