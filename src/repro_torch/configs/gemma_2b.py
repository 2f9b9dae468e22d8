"""gemma-2b [arXiv:2403.08295; hf] — dense, GeGLU, head_dim=256, MQA."""
from repro_torch.configs.base import ModelConfig, register_arch

GEMMA_2B = register_arch(ModelConfig(
    name="gemma-2b",
    family="dense",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,           # MQA
    head_dim=256,
    d_ff=16384,
    vocab=256000,
    activation="gelu_tanh",
    glu=True,               # GeGLU
    rope_theta=10000.0,
    tie_embeddings=True,
    embed_scale=True,
    source="arXiv:2403.08295; hf",
    domain="NLP",
))
