"""minicpm3-4b [dense] — MLA (multi-head latent attention).
[hf:openbmb/MiniCPM3-4B]

62L d_model=2560 40H d_ff=6400 vocab=73448. MLA ranks per the model card:
q_lora=768, kv_lora=256, qk_nope=64, qk_rope=32, v_head=64. The decode KV
cache stores latents only ([kv_lora + rope] per token instead of
2*H*head_dim) — the architecture's defining memory win.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    family="dense",
    num_layers=62,
    d_model=2560,
    num_heads=40,
    num_kv_heads=40,
    d_ff=6400,
    vocab_size=73448,
    head_dim=64,
    mla=True,
    q_lora_rank=768,
    kv_lora_rank=256,
    qk_nope_head_dim=64,
    qk_rope_head_dim=32,
    v_head_dim=64,
    tie_embeddings=True,
    source="hf:openbmb/MiniCPM3-4B",
)


def smoke_config():
    return CONFIG.replace(
        num_layers=2, d_model=256, num_heads=4, num_kv_heads=4, head_dim=32,
        d_ff=512, vocab_size=512, q_lora_rank=64, kv_lora_rank=32,
        qk_nope_head_dim=16, qk_rope_head_dim=16, v_head_dim=16,
        param_dtype="float32", compute_dtype="float32",
        loss_chunk=64, attn_block_kv=64)
