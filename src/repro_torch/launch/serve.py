"""Serving entry point: batched decode behind the AR pub/sub front door.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi_6b \
        [--smoke] [--requests 16] [--prompt-len 16] [--tokens 32] \
        [--device cpu]

Port of ``repro.launch.serve``.  The decode step is registered in the
serverless ``FunctionRegistry`` under a function profile
(``decode:<name>``, profile ``serve`` + the model's name); ``run``
resolves it by associative matching with the ``serve`` interest (the
``armatch`` kernel on the card) and captures it ahead of time there,
as the reference AOT-compiles it: the decode loop replays that CUDA
graph every step (``runtime.capture``; on the CPU the step runs
eagerly).  It prefills each request by decoding its prompt
teacher-forced, then generates greedily (argmax).  Any of the
ten configs serves: attention layers keep ring KV caches and attend
through ``decode_attn``, RWKV6 and RG-LRU layers carry their recurrent
states.  The model is the port's seeded random init unless the caller
hands one in.  Runs on the CUDA card unless the caller asks for the
CPU.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.registry import ARCH_IDS, get_config, smoke_config
from repro_torch.core import profiles as P
from repro_torch.core.serverless import FunctionRegistry
from repro_torch.kernels.decode_attn import decode_attention
from repro_torch.launch import steps as steps_mod
from repro_torch.models import transformer as T


class ServeResult(NamedTuple):
    tokens: np.ndarray          # [requests, tokens] generated ids
    secs: list                  # wall seconds of each decode step
    launches: int               # decode_attn kernel launches in the loop
                                # (0 for a model without attention),
                                # replays counted by the capture
    finite: bool                # every step's logits were finite
    logits: torch.Tensor        # [requests, vocab] after the last step
    caches: list                # the per-layer caches / states at the end
    lengths: torch.Tensor       # [requests] cache fill at the end
    model: T.Transformer
    resolved: str               # the registry entry that served
    aot_cached: int             # the registry's captured steps
    step: Callable              # the captured decode step


def prompts_for(cfg, requests: int, prompt_len: int,
                seed: int = 0) -> np.ndarray:
    """[requests, prompt_len] int32 prompt ids, drawn with numpy."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, (requests, prompt_len)).astype(np.int32)


def run(cfg, requests: int, prompt_len: int, tokens: int, *,
        device: str | torch.device | None = None, seed: int = 0,
        model: T.Transformer | None = None) -> ServeResult:
    """Serve ``requests`` prompts of ``prompt_len`` ids (seeded) and
    generate ``tokens`` ids each.  Every step is timed with a
    synchronize on the card; nothing is read back inside the loop."""
    dev = resolve_device(device)
    if model is None:
        model = T.init_params(cfg, seed=seed, device=dev)
    b, max_len = requests, prompt_len + tokens

    # serverless front door: register the decode topology under a profile
    registry = FunctionRegistry(dev)
    registry.store_function(f"decode:{cfg.name}", P.profile("serve", cfg.name),
                            steps_mod.build_serve_step(cfg))
    interest = P.ProfileBuilder().add_single("serve").build()
    caches = T.init_caches(cfg, b, max_len, dev)
    lengths = torch.zeros((b,), dtype=torch.int32, device=dev)
    tok0 = torch.zeros((b, 1), dtype=torch.int32, device=dev)
    # the caches and lengths are the step's state (donated)
    [(entry, step)] = registry.start_function(interest, model, tok0, caches,
                                              lengths, donate_argnums=(2, 3))

    prompts = torch.from_numpy(prompts_for(cfg, b, prompt_len, seed)).to(dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    finite = torch.ones((), dtype=torch.bool, device=dev)
    secs, gen = [], []
    launches0 = decode_attention.launches
    logits = None
    for t in range(prompt_len + tokens):
        if t < prompt_len:          # prefill: decode the prompt teacher-forced
            tok = prompts[:, t:t + 1]
        else:                       # generate greedily
            tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
            gen.append(tok)
        sync()
        t0 = time.perf_counter()
        logits, caches, lengths = step(model, tok, caches, lengths)
        sync()
        secs.append(time.perf_counter() - t0)
        finite &= torch.isfinite(logits).all()
    out = torch.cat(gen, dim=1) if gen \
        else torch.zeros((b, 0), dtype=torch.int32)
    return ServeResult(out.cpu().numpy(), secs,
                       decode_attention.launches - launches0, bool(finite),
                       logits, caches, lengths, model, entry.name,
                       registry.statistics()["aot_cached"], step)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi_6b", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' for the CPU")
    args = ap.parse_args()

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    res = run(cfg, args.requests, args.prompt_len, args.tokens,
              device=args.device)
    steps = len(res.secs)
    total = args.requests * steps
    print(f"resolved {res.resolved} via AR profile; AOT cache: "
          f"{res.aot_cached}; {res.launches} decode_attn kernel launches")
    print(f"generated {res.tokens.shape} tokens; {total / sum(res.secs):.0f} "
          f"tok/s total ({sum(res.secs) * 1e3 / steps:.1f} ms/step)")
    print("sample:", res.tokens[0, :16])


if __name__ == "__main__":
    main()
