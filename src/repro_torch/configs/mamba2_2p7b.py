"""mamba2-2.7b [arXiv:2405.21060; unverified] — attention-free SSD."""
from repro_torch.configs.base import ModelConfig, register_arch

MAMBA2_2P7B = register_arch(ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,               # attention-free
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab=50280,
    activation="silu",
    glu=False,
    rope_theta=0.0,
    pos_embed="none",
    norm_eps=1e-5,
    tie_embeddings=True,
    d_state=128,
    ssm_headdim=64,          # d_inner = 2*2560 = 5120 -> 80 SSD heads
    expand=2,
    conv_width=4,
    ssm_chunk=256,
    source="arXiv:2405.21060; unverified",
    domain="NLP",
))
