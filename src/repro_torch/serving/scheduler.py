"""Wave-based batched serving scheduler.

Counterpart of ``repro/serving/scheduler.py``, the same algorithm: a fixed
pool of B slots decodes in lock-step, one ``decode_step`` per tick over the
whole batch, with one shared position counter (a host int), so the cache
write slot is the same for every row. Requests are admitted in waves of up
to B; each slot feeds its own prompt token per tick (teacher forcing) until
its prompt is exhausted, then its last sampled token. A wave ends when
every slot is done (max_new_tokens, the EOS id, or max_len); the next wave
admits fresh requests.

Each tick reads the [B] argmax back to the host (as the reference's
``np.asarray`` does): the next tick's tokens depend on it.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.launch.serve import on_device


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # [S] int32
    max_new_tokens: int
    out_tokens: list = field(default_factory=list)
    done: bool = False


class BatchScheduler:
    """Drives ``model.decode_step`` over a fixed slot pool in waves, on
    ``device`` (default ``"cuda"``; params must lie there)."""

    def __init__(self, model, params, *, batch_slots: int, max_len: int,
                 eos_id: int | None = None, device="cuda"):
        self.device = on_device(params, device)
        self.model = model
        self.params = params
        self.B = batch_slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.queue: deque[Request] = deque()
        self.finished: list[Request] = []
        self.ticks = 0

    # ------------------------------------------------------------------ API
    def submit(self, req: Request):
        self.queue.append(req)

    def idle(self) -> bool:
        return not self.queue

    @torch.no_grad()
    def run(self, max_ticks: int = 100_000) -> list[Request]:
        while self.queue and self.ticks < max_ticks:
            self._run_wave(max_ticks)
        return self.finished

    # ---------------------------------------------------------------- engine
    def _run_wave(self, max_ticks: int):
        wave = [self.queue.popleft() for _ in range(min(self.B, len(self.queue)))]
        caches = self.model.make_cache(self.B, self.max_len, device=self.device)
        prompts = [deque(int(x) for x in r.prompt) for r in wave]
        active = [True] * len(wave)
        pos = 0
        while any(active) and pos < self.max_len and self.ticks < max_ticks:
            toks = np.zeros((self.B, 1), np.int32)
            for i, r in enumerate(wave):
                if not active[i]:
                    continue
                toks[i, 0] = (prompts[i].popleft() if prompts[i]
                              else r.out_tokens[-1] if r.out_tokens else 0)
            logits, caches = self.model.decode_step(
                self.params, caches, torch.from_numpy(toks).to(self.device), pos)
            nxt = torch.argmax(logits, dim=-1).cpu().numpy()
            self.ticks += 1
            pos += 1
            for i, r in enumerate(wave):
                if not active[i] or prompts[i]:
                    continue                            # done or still prefilling
                tok = int(nxt[i])
                r.out_tokens.append(tok)
                hit_eos = self.eos_id is not None and tok == self.eos_id
                if hit_eos or len(r.out_tokens) >= r.max_new_tokens \
                        or pos >= self.max_len:
                    r.done = True
                    active[i] = False
                    self.finished.append(r)
        for i, r in enumerate(wave):                    # max_len cutoffs
            if active[i]:
                r.done = True
                self.finished.append(r)
