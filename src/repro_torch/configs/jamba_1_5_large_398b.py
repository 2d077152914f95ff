"""jamba-1.5-large-398b [hybrid] — Mamba + attention 1:7 interleave, MoE.
[arXiv:2403.19887]

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, MoE 16e top-2.
Period-8 layout: [attn, mamba x7]; MoE FFN on every other layer.

The smoke config keeps ``ssm_dt_rank`` at 512: ``__post_init__`` fills it
from the full d_model (ceil(8192 / 16)) and ``replace`` keeps the filled
value, as in the reference.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    pattern="jamba",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    head_dim=128,
    moe=True,
    num_experts=16,
    top_k=2,
    moe_d_ff=24576,
    moe_every=2,
    moe_offset=1,
    ssm_state_dim=16,
    ssm_conv_dim=4,
    ssm_expand=2,
    tie_embeddings=False,
    param_dtype="bfloat16",
    source="arXiv:2403.19887",
)


def smoke_config():
    return CONFIG.replace(
        num_layers=8, d_model=128, num_heads=4, num_kv_heads=2, head_dim=32,
        d_ff=256, moe_d_ff=256, num_experts=4, top_k=2, vocab_size=512,
        param_dtype="float32", compute_dtype="float32",
        loss_chunk=64, attn_block_kv=64, ssm_chunk=16)
