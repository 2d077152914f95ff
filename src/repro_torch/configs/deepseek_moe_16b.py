"""deepseek-moe-16b [moe] — fine-grained experts: 2 shared + 64 routed top-6.
[arXiv:2401.06066]

28L d_model=2048 16H d_ff=1408(per expert) vocab=102400. Layer 0 is a dense
FFN (d_ff=10944) per the paper; layers 1..27 are MoE.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=10944,                       # the single dense layer's hidden dim
    vocab_size=102400,
    head_dim=128,
    moe=True,
    num_experts=64,
    num_shared_experts=2,
    top_k=6,
    moe_d_ff=1408,
    first_dense=1,
    tie_embeddings=False,
    source="arXiv:2401.06066",
)


def smoke_config():
    return CONFIG.replace(
        num_layers=3, d_model=256, num_heads=8, num_kv_heads=8, head_dim=32,
        d_ff=512, moe_d_ff=128, num_experts=4, num_shared_experts=1, top_k=2,
        vocab_size=512, param_dtype="float32", compute_dtype="float32",
        loss_chunk=64, attn_block_kv=64)
