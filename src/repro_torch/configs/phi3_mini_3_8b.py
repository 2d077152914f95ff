"""phi3-mini-3.8b [dense] — RoPE SwiGLU GQA. [arXiv:2404.14219]

32L d_model=3072 32H (GQA kv=32) d_ff=8192 vocab=32064.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    head_dim=96,
    tie_embeddings=False,
    source="arXiv:2404.14219",
)


def smoke_config():
    return CONFIG.replace(
        num_layers=2, d_model=256, num_heads=8, num_kv_heads=8, head_dim=32,
        d_ff=512, vocab_size=512, param_dtype="float32", compute_dtype="float32",
        loss_chunk=64, attn_block_kv=64)
