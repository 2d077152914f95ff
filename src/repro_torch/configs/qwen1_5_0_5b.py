"""qwen1.5-0.5b [dense] — QKV bias. [hf:Qwen/Qwen1.5-0.5B]

24L d_model=1024 16H d_ff=2816 vocab=151936.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    family="dense",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=2816,
    vocab_size=151936,
    head_dim=64,
    qkv_bias=True,
    tie_embeddings=True,
    source="hf:Qwen/Qwen1.5-0.5B",
)


def smoke_config():
    return CONFIG.replace(
        num_layers=2, d_model=256, num_heads=8, num_kv_heads=8, head_dim=32,
        d_ff=512, vocab_size=512, param_dtype="float32", compute_dtype="float32",
        loss_chunk=64, attn_block_kv=64)
