"""Config surface: every shipped YAML parses into a valid DeSTA25Config;
preset tables are consistent; JSON round-trips."""

import glob
import os

import pytest
import yaml

from desta25_audio_tpu.config import (
    DeSTA25Config,
    TARGET_LAYER_IDS,
    _LLM_PRESETS,
    _WHISPER_PRESETS,
    config_from_yaml_model_section,
    llm_config_for,
    whisper_config_for,
)

CONFIG_DIR = os.path.join(os.path.dirname(__file__), "..", "configs")


@pytest.mark.parametrize("path", sorted(glob.glob(f"{CONFIG_DIR}/*.yaml")))
def test_yaml_config_parses(path):
    with open(path) as f:
        cfg = yaml.safe_load(f)
    model_cfg = config_from_yaml_model_section(cfg["model"])
    # resolving the nested tower configs must not raise
    assert model_cfg.llm_config.hidden_size > 0
    assert model_cfg.encoder_config.d_model > 0
    assert model_cfg.audio_token_size > 0
    if model_cfg.connector_mode == "orca_hybrid":
        assert model_cfg.is_orca
        # yaml orca section landed on the dataclass
        assert model_cfg.orca_global_num_tokens == \
            cfg["model"]["orca"]["global_num_tokens"]


def test_every_whisper_preset_has_target_layers():
    for model_id in _WHISPER_PRESETS:
        assert model_id in TARGET_LAYER_IDS, model_id
        cfg = whisper_config_for(model_id)
        for t in TARGET_LAYER_IDS[model_id]:
            assert 0 <= t < cfg.encoder_layers, (model_id, t)


def test_llm_presets_are_consistent():
    for model_id in _LLM_PRESETS:
        cfg = llm_config_for(model_id)
        assert cfg.num_attention_heads % cfg.num_key_value_heads == 0
        assert cfg.vocab_size > cfg.eos_token_id
        assert cfg.chat_template in ("llama3", "qwen3")


def test_unknown_ids_raise():
    with pytest.raises(NotImplementedError, match="not implemented"):
        whisper_config_for("openai/whisper-nonexistent")
    with pytest.raises(NotImplementedError, match="not implemented"):
        llm_config_for("mistralai/Mistral-7B")


def test_json_roundtrip():
    cfg = DeSTA25Config(llm_model_id="test/llama-nano",
                        encoder_model_id="test/whisper-nano",
                        connector_mode="orca_hybrid",
                        orca_global_num_tokens=16)
    back = DeSTA25Config.from_json(cfg.to_json())
    assert back == cfg


def test_turbo_preset_shares_encoder_with_large_v3():
    v3 = whisper_config_for("openai/whisper-large-v3")
    turbo = whisper_config_for("openai/whisper-large-v3-turbo")
    assert turbo.encoder_layers == v3.encoder_layers == 32
    assert turbo.decoder_layers == 4  # the distilled decoder
    assert TARGET_LAYER_IDS["openai/whisper-large-v3-turbo"] == \
        TARGET_LAYER_IDS["openai/whisper-large-v3"]


@pytest.mark.parametrize("enc_layers,taps", [(None, (7, 15, 23, 31)),
                                             (8, (1, 3, 5, 7)),
                                             (4, (0, 1, 2, 3))])
def test_depth_cut_keeps_widths_and_tap_depths(enc_layers, taps):
    cfg = DeSTA25Config(llm_num_hidden_layers=4,
                        encoder_num_layers=enc_layers)
    full = DeSTA25Config()
    assert cfg.llm_config.num_hidden_layers == 4
    assert cfg.llm_config.hidden_size == full.llm_config.hidden_size
    assert cfg.encoder_config.d_model == full.encoder_config.d_model
    assert cfg.encoder_config.encoder_layers == (enc_layers or 32)
    assert cfg.target_layer_ids == taps


def test_depth_cut_below_tap_count_raises():
    with pytest.raises(ValueError, match="connector taps"):
        DeSTA25Config(encoder_num_layers=3).target_layer_ids
