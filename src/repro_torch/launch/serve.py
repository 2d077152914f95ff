"""Batched serving launcher: prefill + decode with KV caches.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \\
        --smoke --batch 4 --prompt-len 32 --gen 16 [--device cuda]

``--arch`` takes any ported architecture: the dense qwen1.5-0.5b,
qwen2.5-3b and phi3-mini-3.8b, the MoE granite-moe-3b-a800m and
deepseek-moe-16b (its leading dense block), minicpm3-4b (MLA: a latent
decode cache), the hybrid jamba-1.5-large-398b, xlstm-125m (mLSTM and
sLSTM states), llava-next-34b and whisper-medium. ``generate`` serves
text only, as the reference's: serving with images calls
``model.prefill`` with ``image_embeds``, ``pad_caches`` to n_img + S +
new, then ``decode_step`` at n_img + S + i; serving whisper calls
``model.prefill`` with ``{"tokens", "frames"}`` (the encoder runs once and
each decoder layer's cross K / V are projected once), ``pad_caches`` to S
+ new (the self k / v grow; the cross k / v and ``enc_out`` pass through),
then ``decode_step`` at S + i (tests/test_serve.py:69's path).

Counterpart of ``repro/launch/serve.py``, with the same flags plus
``--device`` (default ``cuda``). As in the reference, ``--smoke`` is a
``store_true`` flag whose default is already True, so this launcher always
runs the smoke config; full-width runs call ``get_config`` +
``get_model`` + ``generate`` directly (``chip_smoke.py`` does).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import prng
from repro_torch.configs import get_config, get_smoke
from repro_torch.models import get_model
from repro_torch.utils import resolve_device, tree_map


def pad_caches(model, caches, batch, max_len):
    """Grow prefill caches to max_len along the sequence axis (the
    attention k / v caches, MLA's latent and roped-key caches, the leading
    blocks' unstacked ones among them, the enc-dec's self k / v). The
    recurrent states (a Mamba layer's conv tail and ssm state, an mLSTM's
    or sLSTM's conv tail and states) are length-free, and the enc-dec's
    cross k / v and ``enc_out`` are at num_frames rows: they already have
    the full shape and are returned as they are, the same tensors, as is
    the host int ``len``."""
    full = model.make_cache(batch, max_len, device="meta")

    def pad(c, f):
        if not isinstance(c, torch.Tensor) or c.shape == f.shape:
            return c
        out = torch.zeros(f.shape, dtype=c.dtype, device=c.device)
        out[tuple(slice(0, s) for s in c.shape)] = c
        return out
    return tree_map(pad, caches, full)


def on_device(params, device):
    """``device`` resolved (raising if it asks for a missing card), checked
    against where ``params`` lie."""
    dev = resolve_device(device)
    have = params["embed"].device
    if have.type != dev.type or (dev.index is not None and have.index != dev.index):
        raise ValueError(f"params lie on {have}, device={str(device)!r}")
    return have


@torch.no_grad()
def generate(model, params, prompt, max_new, *, greedy=True, rng=None,
             device="cuda"):
    """prompt: [B, S] integers -> tokens [B, S+max_new] (int32, on the
    device). Greedy argmax, one decode step per new token, the position a
    host int: no step waits on the device. Builds no autograd graph."""
    dev = on_device(params, device)
    prompt = torch.as_tensor(prompt, device=dev).to(torch.int32)
    B, S = prompt.shape
    max_len = S + max_new
    caches, logits = model.prefill(params, {"tokens": prompt})
    caches = pad_caches(model, caches, B, max_len)

    out = [prompt]
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    for i in range(max_new):
        out.append(tok)
        logits, caches = model.decode_step(params, caches, tok, S + i)
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    return torch.cat(out, dim=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)

    cfg = get_smoke(a.arch) if a.smoke else get_config(a.arch)
    model = get_model(cfg)
    params = model.init(prng.PRNGKey(0), device=a.device)
    prompt = prng.randint(prng.PRNGKey(1), (a.batch, a.prompt_len), 0,
                          cfg.vocab_size)
    t0 = time.time()
    toks = generate(model, params, prompt, a.gen, device=a.device)
    if toks.device.type == "cuda":
        torch.cuda.synchronize(toks.device)
    dt = time.time() - t0
    print(f"[serve] {cfg.name}: generated {a.batch}x{a.gen} tokens in {dt:.2f}s")
    print(toks[0, -a.gen:])
    return toks


if __name__ == "__main__":
    main()
