"""internlm2-20b [arXiv:2403.17297; hf] — dense, GQA kv=8, SwiGLU."""
from repro_torch.configs.base import ModelConfig, register_arch

INTERNLM2_20B = register_arch(ModelConfig(
    name="internlm2-20b",
    family="dense",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab=92544,
    activation="silu",
    glu=True,
    rope_theta=1000000.0,
    tie_embeddings=False,
    source="arXiv:2403.17297; hf",
    domain="NLP",
))
