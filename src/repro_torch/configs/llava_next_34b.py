"""llava-next-34b [vlm] — LLaVA-NeXT with a 34B (Yi-34B-class) LM backbone.

[hf:llava-hf/llava-v1.6-mistral-7b-hf] (anyres tiling), backbone scaled per
assignment: 60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.
The SigLIP/CLIP vision tower + projector are stubbed: ``input_specs()``
provides patch embeddings [B, num_image_tokens, d_model] directly (anyres =
base 576 tokens x tiles; we expose the token count as the tiling knob).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    head_dim=128,
    vlm=True,
    num_image_tokens=576,             # one anyres base tile
    rope_theta=5_000_000.0,           # Yi-34B long-context base
    tie_embeddings=False,
    param_dtype="bfloat16",           # 34B fp32 exceeds per-device HBM at TP=16
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf (anyres); backbone per assignment",
)


def smoke_config():
    return CONFIG.replace(
        num_layers=2, d_model=256, num_heads=8, num_kv_heads=2, head_dim=32,
        d_ff=512, vocab_size=512, num_image_tokens=16, param_dtype="float32",
        compute_dtype="float32", loss_chunk=64, attn_block_kv=64, ssm_chunk=16)
