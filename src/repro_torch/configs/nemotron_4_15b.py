"""nemotron-4-15b [arXiv:2402.16819; unverified] — dense GQA, squared-ReLU MLP."""
from repro_torch.configs.base import ModelConfig, register_arch

NEMOTRON_4_15B = register_arch(ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab=256000,
    activation="sq_relu",
    glu=False,              # squared-ReLU, no gate
    rope_theta=10000.0,
    tie_embeddings=False,
    source="arXiv:2402.16819; unverified",
    domain="NLP",
))
