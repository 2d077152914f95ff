"""whisper-medium [audio] — encoder-decoder, conv frontend STUBBED.
[arXiv:2212.04356]

24L d_model=1024 16H d_ff=4096 vocab=51865; 24 encoder + 24 decoder layers.
``frames`` [B, 1500, d] stand for the mel + 2xconv frontend's output for
30 s of audio (precomputed frame embeddings; the frontend is a stub, as in
the reference). Served and differentiated by ``models/encdec.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="audio",
    encdec=True,
    num_layers=24,                    # decoder layers
    encoder_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    head_dim=64,
    num_frames=1500,
    rope_theta=10_000.0,              # unused (learned positions)
    tie_embeddings=True,
    source="arXiv:2212.04356",
)


def smoke_config():
    return CONFIG.replace(
        num_layers=2, encoder_layers=2, d_model=256, num_heads=8, num_kv_heads=8,
        head_dim=32, d_ff=512, vocab_size=512, num_frames=32,
        param_dtype="float32", compute_dtype="float32",
        loss_chunk=64, attn_block_kv=64)
