"""whisper-large-v3 [arXiv:2212.04356; unverified] — enc-dec; conv frontend stubbed.

``input_specs()`` provides precomputed (B, 1500, d_model) frame embeddings
per the assignment; the benchmark exercises the transformer backbone only.
"""
from repro_torch.configs.base import ModelConfig, register_arch

WHISPER_LARGE_V3 = register_arch(ModelConfig(
    name="whisper-large-v3",
    family="encdec",
    n_layers=32,             # decoder layers
    n_enc_layers=32,
    enc_seq=1500,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,           # MHA
    head_dim=64,
    d_ff=5120,
    vocab=51866,
    activation="gelu",
    glu=False,
    rope_theta=0.0,
    pos_embed="learned",
    norm_eps=1e-5,
    tie_embeddings=True,
    max_position=32768,      # assigned decode shapes exceed Whisper's 448
    source="arXiv:2212.04356; unverified",
    domain="Speech",
))
