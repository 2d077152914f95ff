"""granite-moe-3b-a800m [moe] — 40 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base family]

32L d_model=1536 24H (GQA kv=8) d_ff=512(per expert) vocab=49155,
MoE 40e top-8, no shared experts.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    head_dim=64,
    moe=True,
    num_experts=40,
    top_k=8,
    moe_d_ff=512,
    tie_embeddings=True,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base (family card)",
)


def smoke_config():
    return CONFIG.replace(
        num_layers=2, d_model=256, num_heads=8, num_kv_heads=4, head_dim=32,
        d_ff=128, moe_d_ff=128, num_experts=4, top_k=2, vocab_size=512,
        param_dtype="float32", compute_dtype="float32",
        loss_chunk=64, attn_block_kv=64)
