"""Serving demo: batched prefill + decode with a KV cache.

The twin of `examples/serve.py`: the same reduced gemma3-4b (local and
global layers interleaved), a batch of 4 synthetic requests, a 16-token
prompt consumed through `decode_step` (teacher-forced prefill), then 24
greedy tokens, a 64-slot cache.  `--arch` serves another registered
model, reduced the same way (jamba-v0.1-52b: an SSM layer, then an
attention layer with the MoE, its cache `pos0` conv/h and `pos1` k/v).
Weights and prompts come from seeded `torch.Generator`s; everything runs
under `torch.inference_mode()`.

    python -m repro_torch.examples.serve                 # on the card
    python -m repro_torch.examples.serve --device cpu [--arch jamba-v0.1-52b]

Runs on CUDA unless `--device cpu` asks for the CPU; with no CUDA device
and no `--device cpu` it raises.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.launch.train import resolve_device
from repro_torch.models import model as M


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.serve")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--arch", default="gemma3-4b",
                    help="the registered model to serve, reduced "
                         "(default gemma3-4b: SWA + global interleave)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    params = M.init_params(cfg, torch.Generator(device).manual_seed(0),
                           device)
    B, prompt_len, gen_len, max_seq = 4, 16, 24, 64
    prompts = torch.randint(0, cfg.vocab_size, (B, prompt_len),
                            generator=torch.Generator(device).manual_seed(1),
                            device=device, dtype=torch.int32)

    with torch.inference_mode():
        # prefill: consume the prompt once, then decode token by token
        cache = M.init_cache(cfg, B, max_seq, device)
        tok = prompts[:, :1]
        t0 = time.time()
        out_tokens = []
        for t in range(prompt_len + gen_len - 1):
            logits, cache = M.decode_step(cfg, params, cache, tok)
            if t + 1 < prompt_len:
                tok = prompts[:, t + 1:t + 2]    # teacher-forced prefill
            else:
                tok = torch.argmax(logits, dim=-1).to(torch.int32)
                out_tokens.append(tok)
        gen = torch.cat(out_tokens, dim=1)
        nan = bool(torch.isnan(logits).any())    # waits for the device
        dt = time.time() - t0
    print(f"served batch={B}: generated {gen.shape[1]} tokens/request "
          f"in {dt:.2f}s ({B * gen.shape[1] / dt:.1f} tok/s)")
    print("sample:", gen[0, :12].tolist())
    if tuple(gen.shape) != (B, gen_len):
        raise RuntimeError(f"generated {tuple(gen.shape)}, want "
                           f"{(B, gen_len)}")
    if nan:
        raise RuntimeError("the logits hold NaN")


if __name__ == "__main__":
    main()
