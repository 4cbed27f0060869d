"""§Perf hillclimb runner: re-trace a chosen (arch x shape) pair with a
config variant and report its roofline terms (the port's counterpart of
`repro/launch/hillclimb.py`, the same experiments).

  PYTHONPATH=src python -m repro_torch.launch.hillclimb --exp starcoder2_band
  PYTHONPATH=src python -m repro_torch.launch.hillclimb --list

Every experiment traces at full width: the hybrid ones (jamba's: the
capacity padding, `moe_ep`, the SSD chunk), the MoE ones (kimi-k2, dbrx)
and the dense ones. An experiment on a family the port lacks would print
`[not ported]` and be skipped.
"""
import argparse
import dataclasses
import json
import os
import sys

# experiment -> (arch, shape, {config overrides})
EXPERIMENTS = {
    # --- hillclimb A: jamba train_4k (worst useful-compute ratio) ---
    "jamba_base": ("jamba-v0.1-52b", "train_4k", {}),
    "jamba_pad16": ("jamba-v0.1-52b", "train_4k", {"moe_pad_capacity": 16}),
    "jamba_pad16_dots": ("jamba-v0.1-52b", "train_4k",
                         {"moe_pad_capacity": 16, "remat_policy": "dots"}),
    "jamba_pad16_ce": ("jamba-v0.1-52b", "train_4k",
                       {"moe_pad_capacity": 16, "chunked_ce": 512}),

    # --- hillclimb B: kimi train_4k (most collective-bound) ---
    "kimi_base": ("kimi-k2-1t-a32b", "train_4k", {}),
    "kimi_pad16": ("kimi-k2-1t-a32b", "train_4k", {"moe_pad_capacity": 16}),
    "kimi_pad16_dots": ("kimi-k2-1t-a32b", "train_4k",
                        {"moe_pad_capacity": 16, "remat_policy": "dots"}),

    # --- hillclimb C: starcoder2 prefill_32k (paper-representative SWA;
    #     banded attention is the beyond-paper TPU optimization) ---
    "starcoder2_base": ("starcoder2-3b", "prefill_32k", {}),
    "starcoder2_band": ("starcoder2-3b", "prefill_32k",
                        {"banded_attention": True}),
    "starcoder2_band_train": ("starcoder2-3b", "train_4k",
                              {"banded_attention": True}),

    "jamba_ep": ("jamba-v0.1-52b", "train_4k", {"moe_ep": True}),
    "kimi_ep": ("kimi-k2-1t-a32b", "train_4k", {"moe_ep": True}),
    "kimi_ep_dots": ("kimi-k2-1t-a32b", "train_4k",
                     {"moe_ep": True, "remat_policy": "dots"}),
    "jamba_ep_dots": ("jamba-v0.1-52b", "train_4k",
                      {"moe_ep": True, "remat_policy": "dots"}),
    "jamba_ep_q64": ("jamba-v0.1-52b", "train_4k",
                     {"moe_ep": True, "ssd_chunk": 64}),
    "kimi_ep_dots_cf1": ("kimi-k2-1t-a32b", "train_4k",
                         {"moe_ep": True, "remat_policy": "dots",
                          "capacity_factor": 1.0}),
    "jamba_ep_q128": ("jamba-v0.1-52b", "train_4k",
                      {"moe_ep": True, "ssd_chunk": 128}),

    # dense memory-bound pairs: remat dots
    "hubert_dots": ("hubert-xlarge", "train_4k", {"remat_policy": "dots"}),
    "phi3v_dots": ("phi-3-vision-4.2b", "train_4k",
                   {"remat_policy": "dots"}),
    "deepseek_dots": ("deepseek-67b", "train_4k", {"remat_policy": "dots"}),

    # --- extras beyond the three required pairs ---
    "dbrx_ep": ("dbrx-132b", "train_4k", {"moe_ep": True}),
    "kimi_ep_prefill": ("kimi-k2-1t-a32b", "prefill_32k", {"moe_ep": True}),
    "dbrx_pad16": ("dbrx-132b", "train_4k", {"moe_pad_capacity": 16}),
    "gemma3_ringkv": ("gemma3-4b", "long_500k", {"window_kv_cache": True}),
    "gemma3_ringkv32k": ("gemma3-4b", "decode_32k",
                         {"window_kv_cache": True}),
    "starcoder2_ringkv": ("starcoder2-3b", "long_500k",
                          {"window_kv_cache": True}),
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--exp", action="append", default=[])
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--json", default="results/hillclimb.jsonl")
    args = ap.parse_args(argv)
    if args.list:
        for k, v in EXPERIMENTS.items():
            print(k, "->", v)
        return 0

    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import (NotPorted, check_ported,
                                           run_pair_roofline)

    for name in args.exp:
        arch, shape, over = EXPERIMENTS[name]
        cfg = get_config(arch)
        if over:
            cfg = dataclasses.replace(cfg, **over)
        print(f"=== {name}: {arch} x {shape} overrides={over}", flush=True)
        try:
            check_ported(cfg)
        except NotPorted as e:
            print(f"[not ported] {name}: {e}", flush=True)
            continue
        rec = run_pair_roofline(arch, shape, cfg=cfg)
        rec["experiment"] = name
        rec["overrides"] = over
        if args.json:
            os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
            with open(args.json, "a") as f:
                f.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
