"""gemma3-12b [hf:google/gemma-3-1b-pt; unverified] — 5:1 local:global, 128k."""
from repro_torch.configs.base import ModelConfig, register_arch

GEMMA3_12B = register_arch(ModelConfig(
    name="gemma3-12b",
    family="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab=262144,
    activation="gelu_tanh",
    glu=True,
    rope_theta=1000000.0,
    qk_norm=True,
    tie_embeddings=True,
    embed_scale=True,
    local_window=1024,
    global_every=6,         # 5 local : 1 global
    max_position=1 << 20,   # 128k trained; lowered structurally to 512k decode
    source="hf:google/gemma-3-1b-pt; unverified",
    domain="NLP",
))
