"""recurrentgemma-9b [arXiv:2402.19427; unverified] — RG-LRU + local attention, 2:1."""
from repro_torch.configs.base import ModelConfig, register_arch

RECURRENTGEMMA_9B = register_arch(ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,             # pattern (rec, rec, attn) x 12 + 2 rec
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,            # MQA on attention layers
    head_dim=256,
    d_ff=12288,
    vocab=256000,
    activation="gelu_tanh",
    glu=True,
    rope_theta=10000.0,
    tie_embeddings=True,
    embed_scale=True,
    local_window=2048,       # attention layers use a 2k local window
    lru_width=4096,
    pattern_rec=2,           # 2 recurrent : 1 attention
    gate_blocks=16,          # Griffin block-diagonal RG-LRU gates
    conv_width=4,
    source="arXiv:2402.19427; unverified",
    domain="NLP",
))
