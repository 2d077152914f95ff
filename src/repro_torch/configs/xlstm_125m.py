"""xlstm-125m [ssm] — alternating mLSTM / sLSTM blocks. [arXiv:2405.04517]

12L d_model=768 4H d_ff=0 vocab=50304. d_ff=0: xLSTM blocks are
self-contained (mLSTM pre-up x2, sLSTM post-up GLU x4/3).
Attention-free => runs long_500k natively (O(1) state per layer).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    pattern="xlstm",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    head_dim=192,
    mlstm_proj_factor=2.0,
    slstm_proj_factor=4.0 / 3.0,
    tie_embeddings=True,
    source="arXiv:2405.04517",
)


def smoke_config():
    return CONFIG.replace(
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=4, head_dim=32,
        vocab_size=512, param_dtype="float32", compute_dtype="float32",
        loss_chunk=64, attn_block_kv=64, ssm_chunk=16)
