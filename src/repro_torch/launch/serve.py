"""Batched serving driver: prefill-free cached decode with request batching.

Serves a reduced model: requests arrive as prompts, are teacher-forced
through ``decode_step`` to fill the KV cache (synchronized batch), then
sampled autoregressively. The loop is :func:`generate`, which takes any
model, the full-width configs included; :class:`BatchedServer` always
serves the reduced, float32 model its :class:`ServeConfig` describes.

  python -m repro_torch.launch.serve --arch gemma_2b --batch 4 --tokens 32

runs on the CUDA device (``--device cpu`` runs the plain PyTorch path).
Sampling draws from a ``torch.Generator`` seeded with ``seed + 1``: the
reference's distribution, not its random stream.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch import configs as CFG
from repro_torch._device import DEFAULT_DEVICE, DeviceLike, resolve_device
from repro_torch.models import (ModelConfig, decode_step, init_cache,
                                init_params, reduced)


@dataclasses.dataclass
class ServeConfig:
    arch: str = "gemma_2b"
    batch: int = 4
    max_len: int = 128
    temperature: float = 0.8
    seed: int = 0
    d_model: int = 128
    layers: int = 4
    vocab_size: int = 512


def generate(params, cfg: ModelConfig, prompts: Sequence[Sequence[int]],
             num_tokens: int, *, max_len: int, temperature: float = 1.0,
             greedy: bool = False,
             generator: Optional[torch.Generator] = None) -> np.ndarray:
    """Decode ``num_tokens`` tokens after each prompt: int32 [B, num_tokens].

    Prompts are right-aligned on pad token 0 and teacher-forced through
    ``decode_step`` one position at a time (synchronized batch), then each
    step's logits over the true vocab give the next token: the argmax when
    ``greedy``, else a draw at ``temperature`` from ``generator`` (on the
    model's device). The tokens stay on the device until the end.
    """
    dev = params.final_norm.device
    b = len(prompts)
    max_prompt = max(len(p) for p in prompts)
    if max_prompt + num_tokens > max_len and not cfg.sliding_window:
        raise ValueError(f"{max_prompt} prompt + {num_tokens} new tokens "
                         f"exceed max_len {max_len}")
    toks = np.zeros((b, max_prompt), np.int64)
    for i, p in enumerate(prompts):
        toks[i, max_prompt - len(p):] = p
    with torch.inference_mode():
        cache = init_cache(cfg, b, max_len, device=dev)
        toks_dev = torch.from_numpy(toks).to(dev)
        logits = None
        for t in range(max_prompt):
            logits, cache = decode_step(params, cache, cfg,
                                        toks_dev[:, t:t + 1])
        out = []
        for _ in range(num_tokens):
            lg = logits[:, 0, :cfg.vocab_size].float()
            if greedy:
                cur = torch.argmax(lg, dim=-1)
            else:
                cur = torch.multinomial(torch.softmax(lg / temperature, -1),
                                        1, generator=generator)[:, 0]
            out.append(cur)
            logits, cache = decode_step(params, cache, cfg, cur[:, None])
        return torch.stack(out, dim=1).to(torch.int32).cpu().numpy()


class BatchedServer:
    def __init__(self, sc: ServeConfig, device: DeviceLike = DEFAULT_DEVICE):
        self.sc = sc
        self.device = resolve_device(device)
        cfg = reduced(CFG.get(sc.arch), layers=sc.layers, d_model=sc.d_model,
                      heads=max(4, sc.d_model // 32), ff=sc.d_model * 4,
                      vocab=sc.vocab_size)
        self.cfg = dataclasses.replace(cfg, dtype="float32")
        self.params = init_params(self.cfg, sc.seed, device=self.device)

    def generate(self, prompts: List[List[int]], num_tokens: int,
                 greedy: bool = False) -> np.ndarray:
        sc = self.sc
        if len(prompts) > sc.batch:
            raise ValueError(f"{len(prompts)} prompts exceed the batch of "
                             f"{sc.batch}")
        gen = torch.Generator(device=self.device).manual_seed(sc.seed + 1)
        return generate(self.params, self.cfg, prompts, num_tokens,
                        max_len=sc.max_len, temperature=sc.temperature,
                        greedy=greedy, generator=gen)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma_2b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="cuda (default) or cpu (the plain PyTorch path)")
    args = ap.parse_args(argv)
    sc = ServeConfig(arch=args.arch, batch=args.batch)
    server = BatchedServer(sc, device=args.device)
    prompts = [[1, 2, 3], [4, 5], [6], [7, 8, 9, 10]][: args.batch]
    t0 = time.perf_counter()
    out = server.generate(prompts, args.tokens)
    dt = time.perf_counter() - t0
    print(f"generated {out.shape} in {dt:.2f}s "
          f"({len(prompts) * args.tokens / dt:.1f} tok/s) on "
          f"{server.device}")
    print(out[:, :16])
    return out


if __name__ == "__main__":
    main()
