"""MusicGen-large — decoder-only over EnCodec tokens; the EnCodec frontend is
a STUB: a batch's ``frames`` (B, S, d_model) are precomputed frame
embeddings that take the place of the token embeddings (decode embeds the
generated tokens). [arXiv:2306.05284]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=2048,
    frontend="audio_frames",
))
