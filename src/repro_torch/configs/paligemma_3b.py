"""paligemma-3b [arXiv:2407.07726; hf] — SigLIP (stub) + gemma-2b backbone.

The SigLIP tower is stubbed per the assignment: ``input_specs()`` provides
256 precomputed patch embeddings which the model prepends (prefix-LM mask).
"""
from repro_torch.configs.base import ModelConfig, register_arch

PALIGEMMA_3B = register_arch(ModelConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,            # MQA (gemma backbone)
    head_dim=256,
    d_ff=16384,
    vocab=257216,
    activation="gelu_tanh",
    glu=True,
    rope_theta=10000.0,
    tie_embeddings=True,
    embed_scale=True,
    n_prefix=256,
    source="arXiv:2407.07726; hf",
    domain="Multimodal",
))
